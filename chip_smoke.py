#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``remixt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Environment: the card's name and power limit, the torch and CUDA
   versions; builds the CUDA kernels from ``remixt_tpu_torch/csrc`` into
   ``build/remixt_tpu_torch/`` (one nvcc per source, all at once) and
   prints the build time.
2. Kernel vs plain, restart-batched: the whole-genome problem (N=6000
   segments at 500 kb, M=3 clones, max copy number 12 → S=355 states, 300
   events, 23 chains) with one wave of R=8 restarts. Forward-backward
   through the ``fb_grouped`` kernel at each cluster size in ``CLUSTERS``
   and once through its plain PyTorch version, all on the card in
   float32, compared on entries within 60 nats of their row maximum at
   atol 2e-4 / rtol 1e-5 and on log_norm at rtol 1e-5. Times each, prints
   the bound beside the design's floor (the breakend bank read once per
   direction), and times the kernel once more with its breakend steps
   made static.
2b. Kernel vs plain, one restart: the same problem with restart 0's state
   through the ``fb_chains`` kernel (each cluster size built) and its plain
   version, at the same tolerances; times both, and ``fb_grouped`` (at its
   default cluster size) on the same inputs at R=1.
2c. The scaled-linear kernel, restart-batched: phase 2's inputs through
   ``fb_grouped_scaled`` at each cluster size in ``CLUSTERS`` and its
   plain version, at phase 2's tolerances; its posteriors within 1e-3 of
   the log-space ``fb_grouped``'s on the same inputs, and two launches on
   the same inputs bit-identical. Times each, prints the bound beside the
   design's floor, and times the kernel with its breakend steps made
   static, as phase 2 does.
2d. The same for ``fb_chains_scaled`` on phase 2b's inputs, at the
   default cluster size, without the made-static probe.
3. The batched path at full width: ``analysis.pipeline.fit_many`` on that
   experiment with the 8 restarts, 2 EM iterations × 2 VI sweeps (the one
   cut: the defaults are 5 × 5). Checks finite ELBOs, the decoded copy
   number's shape, and that every chain forward-backward of the run went
   through the ``fb_grouped`` kernel.
4. float32 on the card vs float64 on the CPU at a small size (N=60, max
   copy number 4, 5 sweeps), restart-batched (R=4) and one restart, each
   with the log-space and with the scaled-linear chain forward-backward:
   posterior max-abs-diff ≤ 1e-3 each.
5. Where the time goes: the batched fit once more (1 EM × 2 VI) under
   ``torch.profiler``: the device's busy share, device time per fit stage,
   and the kernels with the most device time.
6. The single-restart path at full width: the sequential ``fit_many``
   (``batch_restarts: false``) over the first 2 restarts of phase 3's grid,
   2 EM × 2 VI. Checks finite ELBOs, the copy number's shape, and that every
   chain forward-backward went through the ``fb_chains`` kernel; reports its
   stage times and, per restart, the share of segments whose decoded copy
   number equals phase 3's. Then fits restart 0 twice more, as it was and
   under ``torch.use_deterministic_algorithms(True, warn_only=True)``, and
   prints the max abs difference of h, ELBO and posteriors of each from
   the first fit, and the ops torch names as nondeterministic; this only
   reports.
7. Both paths with the scaled-linear switch on (``fb_grouped.SCALED_LINEAR``,
   the ``REMIXT_TPU_SCALED_LINEAR=1`` of the JAX package): phase 3's wave
   through the batched ``fit_many`` and restart 0 through the sequential
   one, at the depth of phases 3 and 6 (2 EM × 2 VI) so that their decoded
   copy number compares with theirs (≥ 0.99 of the segments). Checks that
   every chain forward-backward went through the scaled kernels.

The line before the last holds the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks: HBM bandwidth, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

N_FULL, EVENTS_FULL, CHAINS_FULL, CN_MAX_FULL = 6000, 300, 23, 12
WAVE = 8
NUM_EM_ITER, NUM_UPDATE_ITER = 2, 2
SEQUENTIAL_RESTARTS = 2
BUILD_UNITS = ('fb_grouped', 'fb_chains')
CLUSTERS = (4, 8)
# the scaled fits decode the copy number of the log-space fits on at
# least this share of the segments
SAME_CN_SHARE = 0.99


START = time.time()


def log(msg):
    """Print ``msg`` with the seconds since the script started."""
    print('[{:6.1f} s] {}'.format(time.time() - START, msg), flush=True)


def simulate(N, cn_max, num_events, num_chains, seed):
    from remixt_tpu_torch.simulations import simple as sim
    return sim.simulate_experiment(
        N=N, M=3, h=(0.08, 0.05, 0.025), cn_max=cn_max,
        num_events=num_events, num_chains=num_chains, seed=seed)


def make_model(data, cn_max, device, dtype):
    from remixt_tpu_torch.models.fit import BreakpointModel
    return BreakpointModel(
        data['x'], data['l'], data['adjacencies'], data['breakpoints'],
        max_copy_number=cn_max, max_depth=1e9, min_segment_length=1.0,
        min_proportion_genotyped=0.0, divergence_weight=1e-7,
        random_seed=1234, device=device, dtype=dtype)


def restart_grid(h, num_restarts, seed=1):
    """h initializations spread around the truth, and divergence weights."""
    rng = np.random.RandomState(seed)
    h_inits = [h * (1.0 + 0.1 * rng.rand(3)) for _ in range(num_restarts)]
    weights = [10.0 ** -rng.randint(6, 9) for _ in range(num_restarts)]
    return h_inits, weights


def initial_batch(model, h_inits, weights):
    from remixt_tpu_torch.models import engine as eng
    spec = model._build_spec(3)
    params_b = eng.stack([
        spec.init_params(h, w,
                         total_mask=model._total_likelihood_mask.astype(float),
                         allele_mask=model._allele_likelihood_mask.astype(
                             float))
        for h, w in zip(h_inits, weights)])
    state_b = eng.stack([spec.init_state()] * len(h_inits))
    return spec, params_b, state_b


def cuda_ms(fn, reps):
    """Median device time of ``fn`` over ``reps`` runs, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_environment():
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from remixt_tpu_torch.ops import _build
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    log('torch {} cuda {} python {}'.format(
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    log('card: ' + smi)
    t0 = time.time()
    with ThreadPoolExecutor(len(BUILD_UNITS)) as pool:
        list(pool.map(_build.build, BUILD_UNITS))
    for name in BUILD_UNITS:
        _build.load(name)
    log('phase 1: built {} in {:.2f} s'.format(', '.join(BUILD_UNITS),
                                              time.time() - t0))
    for name in BUILD_UNITS:
        for line in _build.build_logs.get(name, '').splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                log('  ptxas {}: {}'.format(name, line.strip()))
    return smi


def check_messages(pairs):
    """Kernel against plain messages: entries within 60 nats of the row
    maximum at atol 2e-4 / rtol 1e-5. Returns the max abs difference."""
    import torch
    max_err = 0.0
    for got, ref in pairs:
        if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
            raise AssertionError('non-finite forward-backward messages')
        significant = ref > ref.amax(dim=-1, keepdim=True) - 60.0
        diff = (got - ref).abs()[significant]
        tol = 2e-4 + 1e-5 * ref.abs()[significant]
        max_err = max(max_err, float(diff.max()))
        if not bool((diff <= tol).all()):
            raise AssertionError(
                'kernel disagrees with its plain version: max abs '
                'diff {:.3e}'.format(float(diff.max())))
    return max_err


def check_log_norm(spec, kernel, plain):
    """log_norm of the kernel's and the plain messages (R, Q, L, S), rtol
    1e-5."""
    from remixt_tpu_torch.ops import fb_grouped
    ln = [fb_grouped._scatter_and_norm(a, b, spec.chain_seg_map,
                                       spec.chain_last, spec.N)[2]
          for a, b in (kernel, plain)]
    np.testing.assert_allclose(ln[0].cpu().numpy(), ln[1].cpu().numpy(),
                               rtol=1e-5)


def bound(spec, R, inputs, outputs):
    """The least time of one forward-backward of R restarts: each input
    and output array moved once over the HBM rate, or the fp32 work over
    the fp32 rate, whichever is larger. Returns (ms, 'bytes' or
    'operations', bytes_ms, flops_ms, bytes, flops)."""
    S, L = spec.S, spec.L
    nbytes = 4 * sum(x.numel() for x in tuple(inputs) + tuple(outputs))
    steps = spec.chain_bank_idx[:, :L - 1].cpu().numpy()
    matvec_steps = int((steps != 0).sum())
    cut_steps = int((steps == 0).sum())
    # per direction and restart: a 2·S² flop matvec per non-cut step, an
    # S-add sum per cut step, and ~4 flops per state per step around them
    flops = 2 * R * (matvec_steps * 2 * S * S + cut_steps * S
                     + (matvec_steps + cut_steps) * 4 * S)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    flops_ms = 1e3 * flops / PEAK_FP32_FLOP_PER_S
    by = 'bytes' if bytes_ms >= flops_ms else 'operations'
    return max(bytes_ms, flops_ms), by, bytes_ms, flops_ms, nbytes, flops


def kernel_inputs(data, num_restarts):
    """The chain forward-backward's inputs at the main path's shapes: the
    first restarts of phase 3's wave, before their first sweep. Returns
    (spec, frames (R, Q, L, S), static_exp, be_exp_b (R, J, S, S), cbi)."""
    import torch
    from remixt_tpu_torch.models import engine as eng
    from remixt_tpu_torch.ops import fb_grouped

    model = make_model(data, CN_MAX_FULL, 'cuda', torch.float32)
    h_inits, weights = restart_grid(data['h'], WAVE)
    spec, params_b, state_b = initial_batch(model, h_inits[:num_restarts],
                                            weights[:num_restarts])
    with torch.no_grad():
        ll_tot, ll_alle = eng.emission_tensors(spec, params_b)
        frame_b = eng._mix_framelogprob(spec, params_b, state_b, ll_tot,
                                        ll_alle)
        del ll_tot, ll_alle
        be_exp_b = eng.breakend_tmats_exp(spec, state_b.p_breakpoint)
        frames = fb_grouped.gather_frames(frame_b, spec.chain_seg_map)
    return (spec, frames.contiguous(), torch.exp(spec.static_bank).contiguous(),
            be_exp_b, spec.chain_bank_idx.contiguous())


def posterior_diff(spec, messages, reference):
    """Max abs difference of the segment posteriors of two (alphas, betas)
    pairs, chain-major (R, Q, L, S)."""
    from remixt_tpu_torch.ops import fb_grouped
    from remixt_tpu_torch.ops.special import exp_normalize
    post = []
    for a, b in (messages, reference):
        alphas, betas, _ = fb_grouped._scatter_and_norm(
            a, b, spec.chain_seg_map, spec.chain_last, spec.N)
        post.append(exp_normalize(alphas + betas, dim=-1))
    return float((post[0] - post[1]).abs().max())


def made_static(cbi, num_static):
    """The schedule with every breakend step turned into the last static
    class: a kernel timed on it shows what reading the bank costs."""
    import torch
    return torch.where(cbi >= num_static,
                       torch.full_like(cbi, num_static - 1), cbi)


def log_floor(label, spec, cbi, num_static, be_exp_b, nbytes, static_ms,
              cluster):
    """The design's floor, the breakend bank read once per direction, and
    the made-static probe's time."""
    floor_bytes = nbytes + 4 * be_exp_b.numel()
    breakend_steps = (cbi[:, :spec.L - 1] >= num_static).sum(dim=1)
    log('{}: the design\'s floor, the bank once per direction: {:.3f} GB = '
        '{:.3f} ms'.format(label, floor_bytes / 1e9,
                           1e3 * floor_bytes / PEAK_BYTES_PER_S))
    log('{}: with its {} breakend steps (at most {} of a chain\'s {}) made '
        'static (cluster size {}): {:.3f} ms'.format(
            label, int(breakend_steps.sum()), int(breakend_steps.max()),
            spec.L - 1, cluster, static_ms))


def phase_kernel(inputs):
    """The kernel against its plain version at the main path's shapes, at
    each cluster size; also the kernel with every breakend step turned into
    a static one, which shows what reading the per-restart bank costs."""
    import torch
    from remixt_tpu_torch.ops import fb_grouped

    spec, frames, static_exp, be_exp_b, cbi = inputs
    log('phase 2: N={} S={} M={} K={} J={} Q={} L={} R={}'.format(
        spec.N, spec.S, spec.M, spec.K, spec.J, spec.Q, spec.L, WAVE))
    num_static = static_exp.shape[0]
    static_only = made_static(cbi, num_static)
    with torch.no_grad():
        a_p, b_p = fb_grouped.fb_grouped_reference(frames, static_exp,
                                                   be_exp_b, cbi)
        torch.cuda.synchronize()
        cluster_ms, messages, max_err = {}, {}, 0.0
        for cluster in CLUSTERS:
            a_k, b_k = messages[cluster] = fb_grouped.fb_grouped_cuda(
                frames, static_exp, be_exp_b, cbi, cluster=cluster)
            torch.cuda.synchronize()
            max_err = max(max_err, check_messages(((a_k, a_p), (b_k, b_p))))
            check_log_norm(spec, (a_k, b_k), (a_p, b_p))
            cluster_ms[cluster] = cuda_ms(
                lambda: fb_grouped.fb_grouped_cuda(
                    frames, static_exp, be_exp_b, cbi, cluster=cluster),
                reps=7)
        del a_p, b_p
        plain_ms = cuda_ms(lambda: fb_grouped.fb_grouped_reference(
            frames, static_exp, be_exp_b, cbi), reps=5)
        static_ms = cuda_ms(lambda: fb_grouped.fb_grouped_cuda(
            frames, static_exp, be_exp_b, static_only), reps=7)

    bound_ms, bound_by, _, _, nbytes, flops = bound(
        spec, WAVE, (frames, static_exp, be_exp_b, cbi), messages[CLUSTERS[0]])
    log('phase 2: fb_grouped ms by cluster size {}; plain {:.3f} ms; max abs '
        'diff {:.3e}, J={}'.format(
            json.dumps({c: round(t, 4) for c, t in cluster_ms.items()}),
            plain_ms, max_err, be_exp_b.shape[1]))
    log('phase 2: bound {:.3f} ms ({}; {:.3f} GB, {:.3f} GFLOP)'.format(
        bound_ms, bound_by, nbytes / 1e9, flops / 1e9))
    log_floor('phase 2', spec, cbi, num_static, be_exp_b, nbytes, static_ms,
              fb_grouped.CLUSTER)
    return dict(max_abs_err=max_err, ms=cluster_ms[fb_grouped.CLUSTER],
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by), messages[fb_grouped.CLUSTER]


def phase_kernel_chains(inputs):
    """The single-restart kernel against its plain version at the main
    path's shapes: restart 0 of phase 2's wave, each cluster size."""
    import torch
    from remixt_tpu_torch.ops import fb_chains, fb_grouped

    spec, frames, static_exp, be_exp, cbi = inputs
    with torch.no_grad():
        a_p, b_p = fb_chains.fb_chains_reference(frames, static_exp, be_exp,
                                                 cbi)
        torch.cuda.synchronize()
        cluster_ms, messages, max_err = {}, {}, 0.0
        for cluster in CLUSTERS:
            a_k, b_k = messages[cluster] = fb_chains.fb_chains_cuda(
                frames, static_exp, be_exp, cbi, cluster=cluster)
            torch.cuda.synchronize()
            max_err = max(max_err, check_messages(((a_k, a_p), (b_k, b_p))))
            check_log_norm(spec, (a_k[None], b_k[None]),
                           (a_p[None], b_p[None]))
            cluster_ms[cluster] = cuda_ms(
                lambda: fb_chains.fb_chains_cuda(
                    frames, static_exp, be_exp, cbi, cluster=cluster),
                reps=7)
        plain_ms = cuda_ms(lambda: fb_chains.fb_chains_reference(
            frames, static_exp, be_exp, cbi), reps=5)
        grouped_ms = cuda_ms(lambda: fb_grouped.fb_grouped_cuda(
            frames[None], static_exp, be_exp[None], cbi), reps=7)

    bound_ms, bound_by, bytes_ms, flops_ms, nbytes, flops = bound(
        spec, 1, (frames, static_exp, be_exp, cbi), (a_k, b_k))
    log('phase 2b: one restart, Q={} L={} S={} J={}; max abs diff {:.3e}'
        .format(spec.Q, spec.L, spec.S, be_exp.shape[0], max_err))
    log('phase 2b: fb_chains ms by cluster size {}; plain {:.3f} ms; '
        'fb_grouped at R=1 {:.3f} ms'.format(
            json.dumps({c: round(t, 4) for c, t in cluster_ms.items()}),
            plain_ms, grouped_ms))
    log('phase 2b: bound {:.4f} ms ({}): bytes {:.4f} GB = {:.4f} ms, '
        'fp32 {:.3f} GFLOP = {:.4f} ms'.format(
            bound_ms, bound_by, nbytes / 1e9, bytes_ms, flops / 1e9,
            flops_ms))
    return dict(max_abs_err=max_err, ms=cluster_ms[fb_chains.CLUSTER],
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by), messages[fb_chains.CLUSTER]


def phase_kernel_scaled(label, inputs, kernel, plain, log_space, main,
                        clusters, probe=False):
    """A scaled kernel against its plain version on ``inputs`` (R, Q, L, S
    with R = 1 dropped for the single-restart kernel) at each cluster size
    in ``clusters``; its time is the main path's cluster size ``main``'s.
    Also its posteriors
    against the log-space kernel's ``log_space`` messages on the same
    inputs, ≤ 1e-3, and two launches on the same inputs, bit-identical.
    With ``probe``, also the made-static probe and the design's floor, as
    phase 2 prints them."""
    import torch
    from remixt_tpu_torch.ops import fb_grouped

    spec, frames, static_exp, be_exp, cbi = inputs
    R = frames.shape[0] if frames.dim() == 4 else 1
    batch = (lambda m: m) if frames.dim() == 4 else (
        lambda m: tuple(x[None] for x in m))
    cluster_ms, max_err, post_diff = {}, 0.0, 0.0
    with torch.no_grad():
        p = plain(frames, static_exp, be_exp, cbi)
        torch.cuda.synchronize()
        for cluster in clusters:
            k = kernel(frames, static_exp, be_exp, cbi, cluster=cluster)
            again = kernel(frames, static_exp, be_exp, cbi, cluster=cluster)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(k, again)):
                raise AssertionError('{}: two launches at cluster size {} '
                                     'differ'.format(label, cluster))
            del again
            max_err = max(max_err, check_messages(zip(k, p)))
            check_log_norm(spec, batch(k), batch(p))
            post_diff = max(post_diff, posterior_diff(spec, batch(k),
                                                      batch(log_space)))
            if not post_diff <= 1e-3:
                raise AssertionError('{}: posteriors differ from the '
                                     'log-space kernel\'s by {}'.format(
                                         label, post_diff))
            cluster_ms[cluster] = cuda_ms(
                lambda: kernel(frames, static_exp, be_exp, cbi,
                               cluster=cluster), reps=7)
        del p
        plain_ms = cuda_ms(lambda: plain(frames, static_exp, be_exp, cbi),
                           reps=5)
        shift_ms = cuda_ms(lambda: fb_grouped.shift_frames(frames), reps=7)
        if probe:
            static_only = made_static(cbi, static_exp.shape[0])
            static_ms = cuda_ms(lambda: kernel(
                frames, static_exp, be_exp, static_only, cluster=main),
                reps=7)
        fexp, fmax = fb_grouped.shift_frames(frames)

    bound_ms, bound_by, bytes_ms, flops_ms, nbytes, flops = bound(
        spec, R, (fexp, fmax, static_exp, be_exp, cbi), k)
    log('{}: kernel ms by cluster size {} (each with the frame shift in '
        'torch, {:.3f} ms), plain {:.3f} ms, max abs diff {:.3e}; two '
        'launches bit-identical at each'.format(
            label, json.dumps({c: round(t, 4) for c, t in cluster_ms.items()}),
            shift_ms, plain_ms, max_err))
    log('{}: bound {:.4f} ms ({}): bytes {:.4f} GB = {:.4f} ms, fp32 {:.3f} '
        'GFLOP = {:.4f} ms; posterior max abs diff vs the log-space kernel '
        '{:.3e}'.format(label, bound_ms, bound_by, nbytes / 1e9, bytes_ms,
                        flops / 1e9, flops_ms, post_diff))
    if probe:
        log_floor(label, spec, cbi, static_exp.shape[0], be_exp, nbytes,
                  static_ms, main)
    return dict(max_abs_err=max_err, ms=cluster_ms[main],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


@contextlib.contextmanager
def scaled_switch(on):
    """The scaled-linear switch of both chain wrappers, restored after."""
    from remixt_tpu_torch.ops import fb_grouped
    before = fb_grouped.SCALED_LINEAR
    fb_grouped.SCALED_LINEAR = on
    try:
        yield
    finally:
        fb_grouped.SCALED_LINEAR = before


def chain_launches():
    """The launch counters of the four chain kernels, by kernel name."""
    from remixt_tpu_torch.ops import fb_chains, fb_grouped
    return {'fb_grouped': fb_grouped.LAUNCHES,
            'fb_chains': fb_chains.LAUNCHES,
            'fb_grouped_scaled': fb_grouped.LAUNCHES_SCALED,
            'fb_chains_scaled': fb_chains.LAUNCHES_SCALED}


def reset_chain_launches():
    from remixt_tpu_torch.ops import fb_chains, fb_grouped
    fb_grouped.LAUNCHES = fb_chains.LAUNCHES = 0
    fb_grouped.LAUNCHES_SCALED = fb_chains.LAUNCHES_SCALED = 0


def timed_fit(data, num_restarts, batched):
    """``fit_many`` over the first ``num_restarts`` of phase 3's grid,
    batched or one restart at a time, 2 EM × 2 VI, with per-stage wall
    times. Returns the results, each with its segment posteriors under
    ``'posteriors'``, the stages, the wall time and the chain kernels'
    launches during the fit."""
    import torch
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.models import em, engine as eng

    init_params, config, experiment = fit_inputs(
        data, NUM_EM_ITER, num_restarts=num_restarts)
    config['batch_restarts'] = batched
    # the batched functions carry these suffixes
    e, m = ('_restarts', '_batched') if batched else ('', '')
    stages = {}
    timed = stage_timer(stages)
    extract = pipeline._extract_results

    def with_posteriors(model, *args):
        out = extract(model, *args)
        out['posteriors'] = model.state.posterior_marginals.cpu().numpy()
        return out

    pipeline._extract_results = with_posteriors
    originals = [
        (pipeline, '_extract_results', extract),
        (eng, 'variational_sweeps' + e,
         timed(eng, 'variational_sweeps' + e, 'sweeps')),
        (eng, 'calculate_elbo' + e,
         timed(eng, 'calculate_elbo' + e, 'initial_elbo')),
        (em, 'update_h_fused' + m, timed(em, 'update_h_fused' + m,
                                         'h_update')),
        (em, 'param_sample_weights_all' + m,
         timed(em, 'param_sample_weights_all' + m, 'sample_weights')),
        (em, 'update_params_fused' + m,
         timed(em, 'update_params_fused' + m, 'params_update_elbo')),
    ]
    torch.cuda.reset_peak_memory_stats()
    reset_chain_launches()
    t0 = time.time()
    try:
        results = pipeline.fit_many(experiment, init_params, config)
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    torch.cuda.synchronize()
    return results, stages, time.time() - t0, chain_launches()


def expect_launches(label, launches, name, expected):
    """Kernel ``name`` launched ``expected`` times in the run, every other
    chain kernel never."""
    want = {k: expected if k == name else 0 for k in launches}
    if launches != want:
        raise AssertionError('{}: chain kernel launches {}, expected {}'
                             .format(label, launches, want))


def em_iterations(stages, n_em):
    return [sum(stages[k][i] for k in ('sweeps', 'h_update',
                                       'sample_weights',
                                       'params_update_elbo'))
            for i in range(n_em)]


def log_fit(label, stages, wall, n_em, results):
    import torch
    per_sweep = [x / NUM_UPDATE_ITER for x in stages['sweeps']]
    log('{}: wall {:.3f} s; per EM iteration {} s; per sweep {} s'.format(
        label, wall, ['{:.3f}'.format(x) for x in em_iterations(stages, n_em)],
        ['{:.4f}'.format(x) for x in per_sweep]))
    log('{}: stages '.format(label) + json.dumps(
        {k: [round(x, 4) for x in v] for k, v in stages.items()}))
    log('{}: max_memory_allocated {:.3f} GB, ELBOs {}'.format(
        label, torch.cuda.max_memory_allocated() / 1e9,
        np.array2string(check_results(results), precision=2)))


def phase_fit(data):
    """fit_many at full width, with per-stage wall times."""
    results, stages, wall, launches = timed_fit(data, WAVE, batched=True)
    waves = -(-len(results) // WAVE)
    expected = waves * NUM_EM_ITER * NUM_UPDATE_ITER
    expect_launches('phase 3', launches, 'fb_grouped', expected)
    log('phase 3: fit_many, {} restarts in {} wave(s), {} EM x {} VI '
        '(depth cut from the 5 x 5 defaults), fb_grouped launches {}'.format(
            len(results), waves, NUM_EM_ITER, NUM_UPDATE_ITER, expected))
    log_fit('phase 3', stages, wall, NUM_EM_ITER, results)
    truth = data['cn'][:, 1:, :]
    best = max(results.values(), key=lambda r: r['stats']['elbo'])
    dec = best['cn'][:, 1:, :]
    exact = (np.all(dec == truth, axis=(1, 2))
             | np.all(dec == truth[:, :, ::-1], axis=(1, 2)))
    log('phase 3: best restart h {}, exact tumour cn on {:.3f} of segments'
        .format(np.array2string(best['h'], precision=5), exact.mean()))
    return expected, results


def check_results(results):
    """Finite ELBOs and h, copy number of the full width; returns the
    ELBOs."""
    elbos = np.array([r['stats']['elbo'] for r in results.values()])
    if not np.all(np.isfinite(elbos)):
        raise AssertionError('non-finite ELBO: {}'.format(elbos))
    for r in results.values():
        if r['cn'].shape != (N_FULL, 3, 2):
            raise AssertionError('cn shape {}'.format(r['cn'].shape))
        if not np.all(np.isfinite(r['h'])):
            raise AssertionError('non-finite h')
    return elbos


def fit_inputs(data, num_em_iter, num_restarts=WAVE):
    """Phase 3's restart grid, config and experiment."""
    from remixt_tpu_torch.analysis.experiment import Experiment
    h_inits, weights = restart_grid(data['h'], WAVE)
    init_params = {
        i: dict(mode_idx=0, h_normal=h[0], h_tumour=h[1] + h[2],
                mix_frac=h[1] / (h[1] + h[2]), divergence_weight=w,
                max_depth=1e9)
        for i, (h, w) in enumerate(zip(h_inits[:num_restarts],
                                       weights[:num_restarts]))}
    config = dict(max_copy_number=CN_MAX_FULL, num_em_iter=num_em_iter,
                  num_update_iter=NUM_UPDATE_ITER,
                  likelihood_min_segment_length=1.0,
                  likelihood_min_proportion_genotyped=0.0,
                  restart_chunk_size=WAVE, random_seed=1234)
    experiment = Experiment(data['x'], data['l'], data['adjacencies'],
                            data['breakpoints'])
    return init_params, config, experiment


def stage_timer(stages):
    """``timed(module, name, label)`` swaps ``module.name`` for a wrapper
    that appends its synchronized wall time to ``stages[label]``, and
    returns the original."""
    import torch

    def timed(module, name, label):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages.setdefault(label, []).append(time.time() - t0)
            return out
        setattr(module, name, wrapper)
        return fn
    return timed


def same_cn(results, reference):
    """Per restart, the share of segments whose decoded copy number equals
    the reference fit's."""
    return {i: float(np.all(r['cn'] == reference[i]['cn'],
                            axis=(1, 2)).mean())
            for i, r in results.items()}


def phase_sequential_fit(data, batched_results):
    """The single-restart path at full width: the sequential fit_many over
    the first restarts of phase 3's grid, with per-stage wall times."""
    results, stages, wall, launches = timed_fit(
        data, SEQUENTIAL_RESTARTS, batched=False)
    expected = SEQUENTIAL_RESTARTS * NUM_EM_ITER * NUM_UPDATE_ITER
    expect_launches('phase 6', launches, 'fb_chains', expected)
    log('phase 6: sequential fit_many, {} restarts one at a time, {} EM x {} '
        'VI, fb_chains launches {}'.format(
            SEQUENTIAL_RESTARTS, NUM_EM_ITER, NUM_UPDATE_ITER, expected))
    log_fit('phase 6', stages, wall, SEQUENTIAL_RESTARTS * NUM_EM_ITER,
            results)
    log('phase 6: share of segments whose cn equals the batched fit of '
        'phase 3, per restart: ' + json.dumps(same_cn(results,
                                                      batched_results)))
    repeat_fit(data, results[0])
    return expected, results


def repeat_fit(data, first):
    """Restart 0 fitted twice more: as it was, and under torch's
    deterministic algorithms with warnings only. Prints the max abs
    difference of h, ELBO and posteriors of each from phase 6's fit, and
    the ops that torch names as nondeterministic. Reports only; a
    difference fails nothing."""
    import warnings
    import torch

    def diff(again):
        return {key: float(np.abs(np.asarray(pick(first))
                                  - np.asarray(pick(again))).max())
                for key, pick in (('h', lambda r: r['h']),
                                  ('elbo', lambda r: r['stats']['elbo']),
                                  ('posteriors', lambda r: r['posteriors']))}

    log('phase 6: restart 0 fitted again: max abs diff from the first fit '
        '{}'.format(json.dumps(diff(timed_fit(data, 1, batched=False)[0][0]))))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            again = timed_fit(data, 1, batched=False)[0][0]
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split('. ')[0] for w in caught
                  if 'deterministic' in str(w.message).lower()})
    log('phase 6: restart 0 fitted again under torch.use_deterministic_'
        'algorithms(True, warn_only=True): max abs diff from the first fit '
        '{}'.format(json.dumps(diff(again))))
    log('phase 6: ops torch names as nondeterministic in that fit: {}'.format(
        json.dumps(ops) if ops else 'none'))


def phase_scaled_fits(data, batched_results, sequential_results):
    """Both fit paths at full width with the scaled-linear switch on:
    phase 3's wave batched and restart 0 one at a time, against the
    log-space fits of phases 3 and 6."""
    sweeps = NUM_EM_ITER * NUM_UPDATE_ITER
    launches = {}
    with scaled_switch(True):
        for label, num_restarts, batched, name, reference in (
                ('phase 7 batched', WAVE, True, 'fb_grouped_scaled',
                 batched_results),
                ('phase 7 sequential', 1, False, 'fb_chains_scaled',
                 sequential_results)):
            results, stages, wall, counts = timed_fit(data, num_restarts,
                                                      batched)
            expected = -(-num_restarts // WAVE) * sweeps if batched else (
                num_restarts * sweeps)
            expect_launches(label, counts, name, expected)
            launches[name] = expected
            log('{}: fit_many, {} restart(s), {} EM x {} VI, scaled-linear '
                'switch on, {} launches {}'.format(
                    label, num_restarts, NUM_EM_ITER, NUM_UPDATE_ITER, name,
                    expected))
            log_fit(label, stages, wall, (1 if batched else num_restarts)
                    * NUM_EM_ITER, results)
            shares = same_cn(results, reference)
            log('{}: share of segments whose cn equals the log-space fit '
                '(phase {}), per restart: {}'.format(
                    label, 3 if batched else 6, json.dumps(shares)))
            if min(shares.values()) < SAME_CN_SHARE:
                raise AssertionError('{}: scaled fit decodes another copy '
                                     'number on more than {:.0%} of the '
                                     'segments'.format(
                                         label, 1 - SAME_CN_SHARE))
    return launches


def phase_profile(data):
    """One more full-width fit (1 EM × 2 VI) under torch.profiler: the
    device's busy share of the wall time, device time per fit stage, and
    the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.models import em, engine as eng

    init_params, config, experiment = fit_inputs(data, 1)

    def labelled(module, name, label):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            with record_function('stage:' + label):
                return fn(*args, **kwargs)
        setattr(module, name, wrapper)
        return module, name, fn

    originals = [
        labelled(eng, 'variational_sweeps_restarts', 'sweeps'),
        labelled(eng, 'calculate_elbo_restarts', 'initial_elbo'),
        labelled(em, 'update_h_fused_batched', 'h_update'),
        labelled(em, 'update_params_fused_batched', 'params_update_elbo'),
        labelled(eng, 'viterbi_decode', 'viterbi_decode'),
    ]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            torch.cuda.synchronize()
            t0 = time.time()
            pipeline.fit_many(experiment, init_params, config)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.time() - t0)
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)

    # device activity: kernels, copies and sets, not the stage annotations
    # the profiler mirrors onto the device timeline
    intervals = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA
        and not e.name.startswith('stage:'))
    busy, end = 0.0, -np.inf
    for s, e in intervals:
        if e > end:
            busy += e - max(s, end)
            end = e
    if not intervals:
        log('phase 5: the profiler saw no device time: busy share not '
            'measured')
        return
    log('phase 5: profiled fit (1 EM x {} VI): wall {:.1f} ms, device busy '
        '{:.1f} ms ({:.1%}), {} device events'.format(
            NUM_UPDATE_ITER, wall_us / 1e3, busy / 1e3, busy / wall_us,
            len(intervals)))

    def device_us(row):
        return getattr(row, 'device_time_total',
                       getattr(row, 'cuda_time_total', 0.0))

    def self_device_us(row):
        return getattr(row, 'self_device_time_total',
                       getattr(row, 'self_cuda_time_total', 0.0))

    rows = prof.key_averages()
    # a stage's host-side row: its wall time on the host and the device
    # time of the kernels it launched
    for row in sorted((r for r in rows if r.key.startswith('stage:')
                       and r.cpu_time_total > 0),
                      key=lambda r: r.cpu_time_total, reverse=True):
        log('phase 5: {:<26s} calls {:2d}  host {:8.1f} ms  kernels '
            '{:8.1f} ms'.format(row.key[6:], row.count,
                                row.cpu_time_total / 1e3,
                                device_us(row) / 1e3))
    kernels = [r for r in rows if r.device_type == DeviceType.CUDA
               and not r.key.startswith('stage:')]
    for row in sorted(kernels, key=self_device_us, reverse=True)[:8]:
        log('phase 5: kernel {:<56.56s} calls {:6d}  device {:8.2f} ms'
            .format(row.key, row.count, self_device_us(row) / 1e3))


def phase_small_f32_vs_f64():
    import torch
    from remixt_tpu_torch.models import engine as eng

    data = simulate(60, 4, 8, 2, seed=2)
    h_inits, weights = restart_grid(data['h'], 4, seed=3)
    for scaled in (False, True):
        marg = {}
        with scaled_switch(scaled):
            for device, dtype in (('cuda', torch.float32),
                                  ('cpu', torch.float64)):
                model = make_model(data, 4, device, dtype)
                spec, params_b, state_b = initial_batch(model, h_inits,
                                                        weights)
                swept_b = eng.variational_sweeps_restarts(spec, params_b,
                                                          state_b, 5)
                swept = eng.variational_sweeps(spec, eng.take(params_b, 0),
                                               eng.take(state_b, 0), 5)
                marg[device] = [s.posterior_marginals.double().cpu().numpy()
                                for s in (swept_b, swept)]
        recursion = 'scaled-linear' if scaled else 'log-space'
        for label, card, cpu in zip(('R=4', 'one restart'), marg['cuda'],
                                    marg['cpu']):
            diff = float(np.abs(card - cpu).max())
            log('phase 4: {}, f32 card vs f64 CPU, N=60 S={} {}, 5 sweeps: '
                'posterior max abs diff {:.3e}'.format(
                    recursion, cpu.shape[-1], label, diff))
            if not diff <= 1e-3:
                raise AssertionError('f32 posteriors ({}, {}) differ from '
                                     'f64 by {}'.format(recursion, label,
                                                        diff))


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from remixt_tpu_torch.device import resolve_device
    resolve_device('cuda')   # TF32 off

    smi = phase_environment()
    data = simulate(N_FULL, CN_MAX_FULL, EVENTS_FULL, CHAINS_FULL, seed=0)
    from remixt_tpu_torch.ops import fb_chains, fb_grouped
    inputs = kernel_inputs(data, WAVE)
    spec, frames, static_exp, be_exp_b, cbi = inputs
    one = (spec, frames[0], static_exp, be_exp_b[0], cbi)
    grouped, grouped_messages = phase_kernel(inputs)
    chains, chains_messages = phase_kernel_chains(one)
    grouped_scaled = phase_kernel_scaled(
        'phase 2c', inputs, fb_grouped.fb_grouped_scaled_cuda,
        fb_grouped.fb_grouped_scaled_reference, grouped_messages,
        fb_grouped.CLUSTER, CLUSTERS, probe=True)
    chains_scaled = phase_kernel_scaled(
        'phase 2d', one, fb_chains.fb_chains_scaled_cuda,
        fb_chains.fb_chains_scaled_reference, chains_messages,
        fb_chains.CLUSTER, (fb_chains.CLUSTER,))
    del inputs, one, frames, be_exp_b, grouped_messages, chains_messages
    grouped['launches'], batched_results = phase_fit(data)
    phase_small_f32_vs_f64()
    phase_profile(data)
    chains['launches'], sequential_results = phase_sequential_fit(
        data, batched_results)
    scaled_launches = phase_scaled_fits(data, batched_results,
                                        sequential_results)
    grouped_scaled['launches'] = scaled_launches['fb_grouped_scaled']
    chains_scaled['launches'] = scaled_launches['fb_chains_scaled']

    print(smi)
    table = {'kernels': [
        dict(name=name, route='cuda',
             source='remixt_tpu_torch/csrc/{}.cu'.format(source),
             replaces=replaces, launches=k['launches'],
             max_abs_err=k['max_abs_err'], ms=k['ms'],
             plain_ms=k['plain_ms'], bound_ms=k['bound_ms'],
             bound_by=k['bound_by'], library_ms=None)
        for name, source, replaces, k in (
            ('fb_grouped', 'fb_grouped', 'remixt_tpu/ops/fb_pallas.py:744',
             grouped),
            ('fb_chains', 'fb_chains', 'remixt_tpu/ops/fb_pallas.py:152',
             chains),
            ('fb_grouped_scaled', 'fb_grouped',
             'remixt_tpu/ops/fb_pallas.py:911', grouped_scaled),
            ('fb_chains_scaled', 'fb_chains',
             'remixt_tpu/ops/fb_pallas.py:260', chains_scaled))]}
    print(json.dumps(table))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
