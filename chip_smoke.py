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
   through the ``fb_chains`` kernel at every cluster size whose resident
   slice fits (``CHAIN_CLUSTERS``) and its plain version, at the same
   tolerances, with two launches on the same inputs bit-identical; again
   with two non-cut static classes on some chains, so that static steps
   of a class that is not resident run too. Times both, prints the launch
   plan and the card's co-resident clusters at each size, times
   ``fb_grouped`` (at its default cluster size) on the same inputs at R=1
   and the kernel with its breakend steps made static, as phase 2 does.
2c. The scaled-linear kernel, restart-batched: phase 2's inputs through
   ``fb_grouped_scaled`` at each cluster size in ``CLUSTERS`` and its
   plain version, at phase 2's tolerances; its posteriors within 1e-3 of
   the log-space ``fb_grouped``'s on the same inputs, and two launches on
   the same inputs bit-identical. Times each, prints the bound beside the
   design's floor, and times the kernel with its breakend steps made
   static, as phase 2 does.
2d. Phase 2b's checks and times for ``fb_chains_scaled`` on its inputs,
   at every size in ``CHAIN_CLUSTERS``, its trace included, and its
   posteriors within 1e-3 of the log-space ``fb_chains``' at each size.
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
   reports. Last, restart 0 through ``pipeline.fit`` with a snapshot file,
   stopped after one EM iteration and resumed from the snapshot to the
   same depth: its h, ELBO, posteriors and decoded copy number must equal
   the first fit's bit for bit.
7. Both paths with the scaled-linear switch on (``fb_grouped.SCALED_LINEAR``,
   the ``REMIXT_TPU_SCALED_LINEAR=1`` of the JAX package): phase 3's wave
   through the batched ``fit_many`` and restart 0 through the sequential
   one, at the depth of phases 3 and 6 (2 EM × 2 VI) so that their decoded
   copy number compares with theirs (≥ 0.99 of the segments). Checks that
   every chain forward-backward went through the scaled kernels.
8. The ``fit`` workflow at full width: phase 3's problem written as count
   and breakpoint TSVs (``write_tables``), ``create_experiment``, the
   restart grid of ``init`` (the defaults' grid), the grid's fit through
   the workflow's fit task on the card, and ``collate`` into the results
   tables, at phase 3's depth (2 EM × 2 VI). Prints the grid, the waves,
   the wall time of each step and of each wave, and the peak device memory.
   Checks that every chain forward-backward went through ``fb_grouped``,
   finite ELBOs, every key of the results, that the chosen solution is the
   one ``stats`` picks, that each solution's copy number is the fit's, and
   that the workflow run again skips every task in under 10 s. Then the same
   workflow at phase 4's small size (its depths pinned to the truth: the
   default grid's max depth is refused there) in float32 on the card and in
   float64 on the CPU: the same keys and grid, and the chosen solutions' copy
   number equal on at least ``SAME_CN_SHARE`` of the segments. Where h5py
   is missing, the results store cannot be written: the workflow's fit task
   runs alone, ``init`` and ``collate`` run through their table builders in
   memory, every check but the file's is made, and a line says so.
9. Simulate → fit → evaluate at full width and depth: the first simulation
   of ``benchmark/accuracy_sim_defs.yaml`` (``accuracy_0_0``: N=5000, M=3,
   22 autosomes) through the port's ``create_simulations`` and
   ``simulate_experiment`` on the host, which must be the JAX package's
   simulation (``ACCURACY_SIM``: N, detected breakpoints, h, digests of x
   and l); the ``fit`` workflow over init's grid (84 restarts) at the
   defaults, 5 EM × 5 VI, as in phase 8, with every chain forward-backward
   through ``fb_grouped`` (275 launches) and finite ELBOs; the evaluation
   against the truth (``evaluate_tables``, the outlier evaluation
   included), every metric printed beside ``benchmark/ACCURACY_BENCH.json``'s
   row and each of ``ACCURACY_BARS`` held to it; then the grid's restart
   nearest the true h fitted through ``pipeline.fit`` with
   ``optimal_initialization`` (25 ``fb_chains`` launches, a finite ELBO)
   and evaluated. Prints the wall time of each step and the peak device
   memory.

The line before the last holds the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import csv
import hashlib
import importlib.util
import json
import os
import pickle
import shutil
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
# the kernel libraries: (source, macros); fb_chains also with its clock64
# marks, for phase 2b's trace
BUILDS = (('fb_grouped', ()), ('fb_chains', ()),
          ('fb_chains', ('FB_CHAINS_TRACE',)))
CLUSTERS = (4, 8)
# every cluster size whose resident slice fits fb_chains at S=355
CHAIN_CLUSTERS = (3, 4, 5, 6, 7, 8)
# the scaled fits decode the copy number of the log-space fits on at
# least this share of the segments
SAME_CN_SHARE = 0.99
# phase 9: the first simulation of benchmark/accuracy_sim_defs.yaml and
# what the JAX package makes of it on the CPU: its simulate_experiment
# gives N segments, the detected breakpoints, h and the sha256 of x and l
# (float64, C order; first 16 hex digits), and its init the grid's
# restarts
ACCURACY_SIM = dict(name='accuracy_0_0', N=5000, breakpoints=276,
                    h=(0.04, 0.04, 0.02), x='73f71b1c8ae16383',
                    l='e363e17a94417e0d', restarts=84)
# phase 9's bars: each metric within this of the simulation's row of
# benchmark/ACCURACY_BENCH.json (the JAX package's fit at the defaults)
ACCURACY_BARS = {
    'proportion_cn_correct': 0.03, 'proportion_dom_cn_correct': 0.03,
    'brk_cn_correct_proportion': 0.08,
    'mix_pred_0': 0.02, 'mix_pred_1': 0.02, 'mix_pred_2': 0.02,
    'correct_outlier_total_proportion': 0.01,
    'correct_outlier_allele_proportion': 0.01}


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
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        list(pool.map(lambda b: _build.build(*b), BUILDS))
    for build in BUILDS:
        _build.load(*build)
    names = ['+'.join((name,) + defines) for name, defines in BUILDS]
    log('phase 1: built {} in {:.2f} s'.format(', '.join(names),
                                              time.time() - t0))
    for name, (unit, defines) in zip(names, BUILDS):
        for line in _build.build_logs.get((unit,) + defines, '').splitlines():
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


def two_static_classes(static_exp, cbi, seed=5):
    """A schedule with two non-cut static classes on some chains: a copy of
    class 1 perturbed by up to 10 % appended to ``static_exp``, the
    breakend indices moved past it, and every fifth class-1 step of every
    sixth chain pointed at it. Those chains keep class 1 resident and
    stream the new class's steps. Returns (statics, cbi, steps moved)."""
    import torch
    num_static = static_exp.shape[0]
    rng = np.random.RandomState(seed)
    noise = torch.as_tensor(1.0 + 0.1 * rng.rand(*static_exp.shape[1:]),
                            dtype=static_exp.dtype, device=static_exp.device)
    statics = torch.cat([static_exp, (static_exp[1] * noise)[None]])
    steps = cbi.cpu().numpy()
    steps = np.where(steps >= num_static, steps + 1, steps)
    moved = 0
    for q in range(0, steps.shape[0], 6):
        ones = np.flatnonzero(steps[q] == 1)[::5]
        steps[q, ones] = num_static
        moved += len(ones)
    return (statics.contiguous(),
            torch.as_tensor(steps, dtype=cbi.dtype, device=cbi.device), moved)


def phase_kernel_chains(label, inputs, scaled=False, log_space=None):
    """The single-restart kernel (with ``scaled`` the scaled one) against
    its plain version at the main path's shapes: restart 0 of phase 2's
    wave, at every cluster size in ``CHAIN_CLUSTERS``, with two launches
    bit-identical and the card's co-resident clusters at each; again with
    two non-cut static classes on some chains (``two_static_classes``);
    and timed with its breakend steps made static. The scaled kernel's
    posteriors must lie within 1e-3 of the log-space kernel's messages
    ``log_space`` on the same inputs at each size."""
    import torch
    from remixt_tpu_torch.ops import fb_chains, fb_grouped

    spec, frames, static_exp, be_exp, cbi = inputs
    suffix = '_scaled' if scaled else ''
    kernel = getattr(fb_chains, 'fb_chains{}_cuda'.format(suffix))
    plain_fn = getattr(fb_chains, 'fb_chains{}_reference'.format(suffix))
    grouped = getattr(fb_grouped, 'fb_grouped{}_cuda'.format(suffix))
    num_static = static_exp.shape[0]
    statics2, cbi2, moved = two_static_classes(static_exp, cbi)
    with torch.no_grad():
        plain = plain_fn(frames, static_exp, be_exp, cbi)
        plain2 = plain_fn(frames, statics2, be_exp, cbi2)
        torch.cuda.synchronize()
        cluster_ms, kernel_ms, messages, resident_clusters = {}, {}, {}, {}
        max_err = max_err2 = post_diff = 0.0
        for cluster in CHAIN_CLUSTERS:
            k = messages[cluster] = kernel(frames, static_exp, be_exp, cbi,
                                           cluster=cluster)
            again = kernel(frames, static_exp, be_exp, cbi, cluster=cluster)
            k2 = kernel(frames, statics2, be_exp, cbi2, cluster=cluster)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(k, again)):
                raise AssertionError('{}: two launches at cluster size {} '
                                     'differ'.format(label, cluster))
            del again
            max_err = max(max_err, check_messages(zip(k, plain)))
            check_log_norm(spec, tuple(x[None] for x in k),
                           tuple(x[None] for x in plain))
            max_err2 = max(max_err2, check_messages(zip(k2, plain2)))
            check_log_norm(spec, tuple(x[None] for x in k2),
                           tuple(x[None] for x in plain2))
            del k2
            if scaled:
                post_diff = max(post_diff, posterior_diff(
                    spec, tuple(x[None] for x in k),
                    tuple(x[None] for x in log_space)))
                if not post_diff <= 1e-3:
                    raise AssertionError('{}: posteriors differ from the '
                                         'log-space kernel\'s by {}'.format(
                                             label, post_diff))
            resident_clusters[cluster] = fb_chains.max_active_clusters(
                spec.S, cluster, scaled)
            cluster_ms[cluster] = cuda_ms(
                lambda: kernel(frames, static_exp, be_exp, cbi,
                               cluster=cluster), reps=7)
            kernel_ms[cluster] = cuda_ms(fb_chains.launcher(
                frames, static_exp, be_exp, cbi, cluster=cluster,
                scaled=scaled)[0], reps=7)
        del plain, plain2
        plain_ms = cuda_ms(lambda: plain_fn(frames, static_exp, be_exp, cbi),
                           reps=5)
        grouped_ms = cuda_ms(lambda: grouped(
            frames[None], static_exp, be_exp[None], cbi), reps=7)
        static_only = made_static(cbi, num_static)
        static_ms = cuda_ms(lambda: kernel(
            frames, static_exp, be_exp, static_only), reps=7)
        static_kernel_ms = cuda_ms(fb_chains.launcher(
            frames, static_exp, be_exp, static_only, scaled=scaled)[0],
            reps=7)
        resident = fb_chains.resident_classes(cbi, num_static, spec.L - 1)
        traces = {sched_label: fb_chains.trace(frames, static_exp, be_exp,
                                               sched, scaled=scaled)
                  for sched_label, sched in (('main', cbi),
                                             ('made static', static_only))}
        # the scaled kernel reads fexp and fmax in place of the frames
        moved_inputs = (frames,)
        if scaled:
            shift_ms = cuda_ms(lambda: fb_grouped.shift_frames(frames),
                               reps=7)
            moved_inputs = fb_grouped.shift_frames(frames)

    k = messages[fb_chains.CLUSTER]
    bound_ms, bound_by, bytes_ms, flops_ms, nbytes, flops = bound(
        spec, 1, moved_inputs + (static_exp, be_exp, cbi), k)
    log('{}: one restart, Q={} L={} S={} J={}; resident classes {}; '
        'max abs diff {:.3e}; two launches bit-identical at each size'.format(
            label, spec.Q, spec.L, spec.S, be_exp.shape[0],
            json.dumps(resident.cpu().tolist()), max_err))
    log('{}: {} ms by cluster size {} (the kernel alone, on inputs the '
        'wrapper prepared: {}); plain {:.3f} ms; {} at R=1 {:.3f} ms{}'.format(
            label, 'fb_chains' + suffix,
            json.dumps({c: round(t, 4) for c, t in cluster_ms.items()}),
            json.dumps({c: round(t, 4) for c, t in kernel_ms.items()}),
            plain_ms, 'fb_grouped' + suffix, grouped_ms,
            '; the frame shift in torch, in the times through the wrapper, '
            '{:.3f} ms'.format(shift_ms) if scaled else ''))
    log('{}: launch plans {}'.format(label, json.dumps(
        {c: fb_chains.launch_plan(spec.S, c) for c in CHAIN_CLUSTERS})))
    log('{}: co-resident clusters by cluster size {} ({} clusters on '
        'the main path)'.format(label, json.dumps(resident_clusters),
                                2 * spec.Q))
    log('{}: two non-cut static classes ({} steps of every sixth chain '
        'moved to a perturbed copy of class 1): max abs diff {:.3e} at '
        'each size'.format(label, moved, max_err2))
    log('{}: bound {:.4f} ms ({}): bytes {:.4f} GB = {:.4f} ms, '
        'fp32 {:.3f} GFLOP = {:.4f} ms'.format(
            label, bound_ms, bound_by, nbytes / 1e9, bytes_ms, flops / 1e9,
            flops_ms))
    if scaled:
        log('{}: posterior max abs diff vs the log-space kernel {:.3e} '
            '(worst size)'.format(label, post_diff))
    log_floor(label, spec, cbi, num_static, be_exp, nbytes, static_ms,
              fb_chains.CLUSTER)
    log('{}: made static, the kernel alone: {:.4f} ms'.format(
        label, static_kernel_ms))
    for sched_label, rows in traces.items():
        log_trace('{} {}'.format(label, sched_label), rows)
    return dict(max_abs_err=max_err, ms=cluster_ms[fb_chains.CLUSTER],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by), k


def log_trace(label, rows):
    """The kernel's clock64 marks (``fb_chains.trace``): per direction, the
    mean cycles a step of each part over the chains, the card's clock, and
    the slowest (chain, direction) with its steps' span."""
    from remixt_tpu_torch.ops import fb_chains
    cols = fb_chains.TRACE_COLUMNS
    steps = rows[:, 4:8].sum(axis=1)
    span_ns = rows[:, 9] - rows[:, 8]
    cycles = rows[:, :4].sum(axis=1)
    ghz = float(np.median(cycles / span_ns))
    for d, name in ((0, 'forward'), (1, 'reverse')):
        part = rows[d::2]
        kinds = dict(zip(cols[4:8], part[:, 4:8].sum(axis=0).tolist()))
        log('{}: {} mean cycles a step {}; steps {}'.format(
            label, name, json.dumps({
                cols[k]: round(float((part[:, k] / steps[d::2]).mean()), 1)
                for k in range(4)}), json.dumps(kinds)))
    worst = int(cycles.argmax())
    log('{}: {:.3f} GHz; slowest chain {} {}: {:.1f} us, {} cycles; the '
        'steps of all chains end within {:.1f} us of the first start'.format(
            label, ghz, worst // 2, ('forward', 'reverse')[worst % 2],
            span_ns[worst] / 1e3, int(cycles[worst]),
            (rows[:, 9].max() - rows[:, 8].min()) / 1e3))


def phase_kernel_scaled(inputs, log_space):
    """The restart-batched scaled kernel against its plain version on phase
    2's inputs at each cluster size in ``CLUSTERS``; its time is the main
    path's cluster size's. Also its posteriors against the log-space
    kernel's ``log_space`` messages on the same inputs, ≤ 1e-3, two
    launches on the same inputs bit-identical, and the made-static probe
    and the design's floor, as phase 2 prints them."""
    import torch
    from remixt_tpu_torch.ops import fb_grouped

    label = 'phase 2c'
    spec, frames, static_exp, be_exp, cbi = inputs
    kernel = fb_grouped.fb_grouped_scaled_cuda
    plain = fb_grouped.fb_grouped_scaled_reference
    cluster_ms, max_err, post_diff = {}, 0.0, 0.0
    with torch.no_grad():
        p = plain(frames, static_exp, be_exp, cbi)
        torch.cuda.synchronize()
        for cluster in CLUSTERS:
            k = kernel(frames, static_exp, be_exp, cbi, cluster=cluster)
            again = kernel(frames, static_exp, be_exp, cbi, cluster=cluster)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(k, again)):
                raise AssertionError('{}: two launches at cluster size {} '
                                     'differ'.format(label, cluster))
            del again
            max_err = max(max_err, check_messages(zip(k, p)))
            check_log_norm(spec, k, p)
            post_diff = max(post_diff, posterior_diff(spec, k, log_space))
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
        static_only = made_static(cbi, static_exp.shape[0])
        static_ms = cuda_ms(lambda: kernel(
            frames, static_exp, be_exp, static_only), reps=7)
        fexp, fmax = fb_grouped.shift_frames(frames)

    bound_ms, bound_by, bytes_ms, flops_ms, nbytes, flops = bound(
        spec, frames.shape[0], (fexp, fmax, static_exp, be_exp, cbi), k)
    log('{}: kernel ms by cluster size {} (each with the frame shift in '
        'torch, {:.3f} ms), plain {:.3f} ms, max abs diff {:.3e}; two '
        'launches bit-identical at each'.format(
            label, json.dumps({c: round(t, 4) for c, t in cluster_ms.items()}),
            shift_ms, plain_ms, max_err))
    log('{}: bound {:.4f} ms ({}): bytes {:.4f} GB = {:.4f} ms, fp32 {:.3f} '
        'GFLOP = {:.4f} ms; posterior max abs diff vs the log-space kernel '
        '{:.3e}'.format(label, bound_ms, bound_by, nbytes / 1e9, bytes_ms,
                        flops / 1e9, flops_ms, post_diff))
    log_floor(label, spec, cbi, static_exp.shape[0], be_exp, nbytes,
              static_ms, fb_grouped.CLUSTER)
    return dict(max_abs_err=max_err, ms=cluster_ms[fb_grouped.CLUSTER],
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
    resume_fit(data, results[0])
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


def resume_fit(data, first):
    """Restart 0 through ``pipeline.fit`` with a snapshot file, stopped
    after one EM iteration and resumed from the snapshot to phase 6's
    depth, as a killed ``fit_task`` job resumes. Prints the max abs
    difference of h, ELBO, posteriors and decoded copy number (segments
    and breakpoints) from phase 6's uninterrupted fit; any nonzero
    difference fails."""
    import os
    from remixt_tpu_torch.analysis import pipeline

    init_params, config, experiment = fit_inputs(data, 1, num_restarts=1)
    snapshot = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'build', 'chip_smoke', 'restart0.ckpt')
    os.makedirs(os.path.dirname(snapshot), exist_ok=True)
    if os.path.exists(snapshot):
        os.remove(snapshot)
    extract = pipeline._extract_results

    def with_posteriors(model, *args):
        out = extract(model, *args)
        out['posteriors'] = model.state.posterior_marginals.cpu().numpy()
        return out

    pipeline._extract_results = with_posteriors
    try:
        pipeline.fit(experiment, init_params[0], config,
                     snapshot_filename=snapshot)
        config['num_em_iter'] = NUM_EM_ITER
        resumed = pipeline.fit(experiment, init_params[0], config,
                               snapshot_filename=snapshot)
    finally:
        pipeline._extract_results = extract
        if os.path.exists(snapshot):
            os.remove(snapshot)

    def max_diff(a, b):
        return float(np.abs(np.asarray(a, dtype=float)
                            - np.asarray(b, dtype=float)).max())

    diff = {key: max_diff(pick(first), pick(resumed))
            for key, pick in (('h', lambda r: r['h']),
                              ('elbo', lambda r: r['stats']['elbo']),
                              ('posteriors', lambda r: r['posteriors']),
                              ('cn', lambda r: r['cn']))}
    brk, brk_ref = resumed['brk_cn'], first['brk_cn']
    diff['brk_cn'] = (max([max_diff(brk[k], brk_ref[k]) for k in brk_ref]
                          + [0.0]) if set(brk) == set(brk_ref)
                      else float('inf'))
    log('phase 6: restart 0 through pipeline.fit stopped after 1 EM '
        'iteration and resumed from its snapshot to {}: max abs diff from '
        'the uninterrupted fit {}'.format(NUM_EM_ITER, json.dumps(diff)))
    if any(v != 0.0 for v in diff.values()):
        raise AssertionError('phase 6: the resumed fit differs from the '
                             'uninterrupted one: {}'.format(diff))


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


def write_tables(data, directory, segment_length=500000):
    """Count and breakpoint TSVs of a simulated experiment in the reference
    schema; chains become chromosomes (positions restart per chromosome),
    as in ``tests/test_pipeline.make_tables``. Returns their paths."""
    N = data['x'].shape[0]
    chrom = np.zeros(N, dtype=int)
    pos = np.zeros(N, dtype=int)
    for n in range(1, N):
        adjacent = (n - 1, n) in data['adjacencies']
        chrom[n] = chrom[n - 1] + (0 if adjacent else 1)
        pos[n] = pos[n - 1] + 1 if adjacent else 0
    start = pos * segment_length + 1
    end = (pos + 1) * segment_length
    count_file = os.path.join(directory, 'counts.tsv')
    breakpoint_file = os.path.join(directory, 'breakpoints.tsv')
    with open(count_file, 'w', newline='') as f:
        out = csv.writer(f, delimiter='\t', lineterminator='\n')
        out.writerow(['chromosome', 'start', 'end', 'length',
                      'major_readcount', 'minor_readcount', 'readcount',
                      'major_is_allele_a'])
        for n in range(N):
            out.writerow([str(chrom[n] + 1), start[n], end[n],
                          repr(float(data['l'][n]))]
                         + [int(v) for v in data['x'][n]] + [1])
    with open(breakpoint_file, 'w', newline='') as f:
        out = csv.writer(f, delimiter='\t', lineterminator='\n')
        out.writerow(['prediction_id', 'chromosome_1', 'strand_1',
                      'position_1', 'chromosome_2', 'strand_2', 'position_2'])
        for bp_id, bp in data['breakpoints'].items():
            row = [bp_id]
            for n, side in sorted(bp):
                row += [str(chrom[n] + 1), '+' if side == 1 else '-',
                        end[n] if side == 1 else start[n]]
            out.writerow(row)
    return count_file, breakpoint_file


HAVE_H5PY = importlib.util.find_spec('h5py') is not None


def tsv_experiment(data, root):
    """A fresh ``root`` with ``data`` written as count and breakpoint TSVs
    and ``create_experiment`` run on them. Returns the experiment file and
    the seconds ``create_experiment`` took."""
    from remixt_tpu_torch.analysis import experiment as experiment_mod
    fresh_directory(root)
    count_file, breakpoint_file = write_tables(data, root)
    experiment_file = os.path.join(root, 'experiment.pickle')
    t0 = time.time()
    experiment_mod.create_experiment(count_file, breakpoint_file,
                                     experiment_file)
    return experiment_file, time.time() - t0


def fresh_directory(root):
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)


def fit_workflow(label, experiment_file, config, device, root):
    """One sample's pickled experiment through the ``fit`` workflow in
    ``root``: ``init``, the fit task, ``collate``, then the workflow run
    again on its work directory. Without h5py the fit task runs alone in
    the workflow and ``init`` and ``collate`` through their table builders.

    Returns dict(init_params, tables, fits {init_id: pickled results},
    times {step: seconds, 'whole' from init to the tables}, waves [seconds
    of each wave of the batched fit], launches, rerun seconds, rerun
    launches).
    """
    import torch
    from remixt_tpu_torch import workflow
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.io import hdf5
    from remixt_tpu_torch.models import engine as eng
    from remixt_tpu_torch.scheduler import Workflow

    results_file = os.path.join(root, 'results.h5')
    tempdir = os.path.join(root, 'fit')
    stages, captured, marks = {}, {}, []
    timed = stage_timer(stages)
    init_tables = pipeline.init_tables
    elbo0, batched = eng.calculate_elbo_restarts, pipeline.fit_restarts_batched

    def capture_init(*args, **kwargs):
        captured['init'] = init_tables(*args, **kwargs)
        return captured['init']

    def wave_start(*args, **kwargs):
        torch.cuda.synchronize()
        marks.append(time.time())
        return elbo0(*args, **kwargs)

    def waves(*args, **kwargs):
        out = batched(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.time())
        return out

    pipeline.init_tables = capture_init
    eng.calculate_elbo_restarts = wave_start
    pipeline.fit_restarts_batched = waves
    originals = [(pipeline, 'init_tables', init_tables),
                 (eng, 'calculate_elbo_restarts', elbo0),
                 (pipeline, 'fit_restarts_batched', batched)]
    originals += [(module, name, timed(module, name, step)) for module, name,
                  step in ((pipeline, 'init_tables', 'init'),
                           (pipeline, 'fit_many', 'fit'),
                           (pipeline, 'collate_tables', 'collate'))]

    def build():
        if HAVE_H5PY:
            return workflow.create_fit_model_workflow(
                experiment_file, results_file, config, None, tempdir,
                device=device)
        flow = Workflow('fit_model')
        flow.transform('fit', workflow.fit_all_restarts,
                       args=(os.path.join(tempdir, 'fit_results'),
                             experiment_file, captured['init'][0], config),
                       kwargs={'device': device}, inputs=[experiment_file])
        return flow

    try:
        if device is None:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        if not HAVE_H5PY:
            with open(experiment_file, 'rb') as f:
                experiment = pickle.load(f)
            pipeline.init_tables(experiment, config)
        reset_chain_launches()
        build().run(root)
        launches = chain_launches()
        init_params, init_store = captured['init']
        fits = {}
        for init_id in init_params:
            with open(os.path.join(tempdir, 'fit_results',
                                   'fit_{}.pickle'.format(init_id)),
                      'rb') as f:
                fits[init_id] = pickle.load(f)
        if HAVE_H5PY:
            tables = hdf5.read_store(results_file)
        else:
            tables = pipeline.collate_tables(experiment, fits, init_store,
                                             config)
            try:
                hdf5.write_store(results_file, tables)
            except ImportError as error:
                log('{}: h5py is absent: the results store is not written '
                    '({}); init and collate ran through their table '
                    'builders in memory and every check but the file\'s is '
                    'made'.format(label, error))
            else:
                raise AssertionError('write_store wrote without h5py')
        stages['whole'] = [time.time() - t0]
        t1 = time.time()
        reset_chain_launches()
        build().run(root)
        rerun, rerun_launches = time.time() - t1, chain_launches()
    finally:
        for module, name, fn in reversed(originals):
            setattr(module, name, fn)
    return dict(init_params=init_params, tables=tables, fits=fits,
                times={k: v[0] for k, v in stages.items()},
                waves=np.diff(marks).tolist(),
                launches=launches, rerun=rerun,
                rerun_launches=rerun_launches)


def check_rerun(label, run):
    """The workflow run again skipped every task in under 10 s."""
    if run['rerun'] >= 10.0 or any(run['rerun_launches'].values()):
        raise AssertionError('{}: the workflow run again took {:.3f} s '
                             'and launched {}'.format(
                                 label, run['rerun'], run['rerun_launches']))
    log('{}: the workflow run again skipped every task in {:.3f} s'
        .format(label, run['rerun']))


def check_results_tables(label, run, config, N):
    """The results tables of a workflow run against its fits: every key,
    finite ELBOs, the chosen solution the one ``stats`` picks (the first
    largest ELBO among restarts under ``max_prop_diverge``, else among all),
    and each solution's copy number the fit's."""
    from remixt_tpu_torch import config as config_mod
    tables, fits = run['tables'], run['fits']
    keys = {'stats', 'read_depth', 'minor_modes', 'cn', 'mix', 'brk_cn'}
    for init_id in run['init_params']:
        keys |= {'solutions/solution_{}/{}'.format(init_id, name)
                 for name in ('cn', 'brk_cn', 'h', 'mix')}
    if set(tables) != keys:
        raise AssertionError('{}: results keys {} missing, {} extra'.format(
            label, sorted(keys - set(tables)), sorted(set(tables) - keys)))
    stats = tables['stats']
    if not np.all(np.isfinite(stats['elbo'])):
        raise AssertionError('{}: non-finite ELBO'.format(label))
    if sorted(stats['init_id'].tolist()) != sorted(run['init_params']):
        raise AssertionError('{}: stats rows are not the grid'.format(label))
    passing = np.flatnonzero(stats['proportion_divergent'] < config_mod
                             .get_param(config, 'max_prop_diverge'))
    if len(passing) == 0:
        passing = np.arange(len(stats['elbo']))
    best = stats['init_id'][passing[np.argmax(stats['elbo'][passing])]]
    for name in ('cn', 'mix', 'brk_cn'):
        if not same_table(tables[name], tables[
                'solutions/solution_{}/{}'.format(best, name)]):
            raise AssertionError('{}: /{} is not solution {}\'s'.format(
                label, name, best))
    for init_id, fit in fits.items():
        table = tables['solutions/solution_{}/cn'.format(init_id)]
        if fit['cn'].shape[0] != N or not all(
                np.array_equal(table['{}_{}'.format(allele, m)],
                               fit['cn'][:, m, a])
                for m in range(fit['cn'].shape[1])
                for a, allele in enumerate(('major', 'minor'))):
            raise AssertionError('{}: solution {}\'s copy number is not the '
                                 'fit\'s'.format(label, init_id))
    return best


def same_table(a, b):
    """Two Tables or Series with equal columns, values and index."""
    if hasattr(a, 'columns'):
        return (a.columns == b.columns and np.array_equal(a.index, b.index)
                and all(np.array_equal(a[c], b[c]) for c in a.columns))
    return (np.array_equal(a.values, b.values)
            and np.array_equal(a.index, b.index))


def chosen_cn(run):
    """The chosen solution's (N, M, 2) copy number from the /cn table."""
    cn = run['tables']['cn']
    M = sum(1 for c in cn.columns if c.startswith('major_')
            and c[6:].isdigit())
    return np.stack([np.stack([cn['major_{}'.format(m)],
                               cn['minor_{}'.format(m)]], axis=1)
                     for m in range(M)], axis=1)


def phase_workflow(data):
    """The fit workflow at full width on the card, then the small-size
    float32 card / float64 CPU comparison. Returns the fb_grouped launches
    of both card runs."""
    import torch
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'chip_smoke', 'workflow')
    config = dict(num_em_iter=NUM_EM_ITER, num_update_iter=NUM_UPDATE_ITER)
    experiment_file, experiment_s = tsv_experiment(data, root)
    run = fit_workflow('phase 8', experiment_file, config, None, root)
    restarts = len(run['init_params'])
    waves = -(-restarts // WAVE)
    expected = waves * NUM_EM_ITER * NUM_UPDATE_ITER
    expect_launches('phase 8', run['launches'], 'fb_grouped', expected)
    best = check_results_tables('phase 8', run, config, data['x'].shape[0])
    depths = sorted({p['max_depth'] for p in run['init_params'].values()})
    log('phase 8: fit workflow, grid of {} restarts ({} modes) in {} waves '
        'of {}, max_depth {}, {} EM x {} VI; fb_grouped launches {}'.format(
            restarts, len({p['mode_idx'] for p in
                           run['init_params'].values()}),
            waves, WAVE, json.dumps(depths), NUM_EM_ITER, NUM_UPDATE_ITER,
            expected))
    times = run['times']
    log('phase 8: wall s: experiment {:.3f}, init {:.3f}, fit {:.3f} (waves '
        '{:.3f}, decode and results {:.3f}), collate {:.3f}, whole {:.3f}; '
        'per wave {}'.format(
            experiment_s, times['init'], times['fit'], sum(run['waves']),
            times['fit'] - sum(run['waves']), times['collate'],
            experiment_s + times['whole'],
            json.dumps([round(w, 3) for w in run['waves']])))
    log('phase 8: max_memory_allocated {:.3f} GB; chosen solution {}; '
        'ELBOs {:.6g} to {:.6g}'.format(
            torch.cuda.max_memory_allocated() / 1e9, best,
            float(np.min(run['tables']['stats']['elbo'])),
            float(np.max(run['tables']['stats']['elbo']))))
    check_rerun('phase 8', run)

    # the default grid's common max depth at max copy number 4 leaves 65 %
    # of this problem unmodellable, which init refuses (as the JAX
    # package's does): pin the depths to the truth, as tests/test_cli.py
    # does for its tiny problem, which makes a grid of one mode
    small = simulate(60, 4, 8, 2, seed=2)
    small_config = dict(config, max_copy_number=4,
                        h_normal=float(small['h'][0]),
                        h_tumour=float(small['h'][1:].sum()))
    runs, chosen, whole = {}, {}, {}
    for name, device, dtype in (('card f32', None, 'float32'),
                                ('CPU f64', 'cpu', 'float64')):
        experiment_file, experiment_s = tsv_experiment(small, root + '_small')
        runs[name] = fit_workflow(
            'phase 8 small ' + name, experiment_file,
            dict(small_config, engine_dtype=dtype), device, root + '_small')
        whole[name] = experiment_s + runs[name]['times']['whole']
        chosen[name] = check_results_tables('phase 8 small ' + name,
                                            runs[name], small_config, 60)
    card, cpu = runs['card f32'], runs['CPU f64']
    small_waves = -(-len(card['init_params']) // WAVE)
    expect_launches('phase 8 small card f32', card['launches'], 'fb_grouped',
                    small_waves * NUM_EM_ITER * NUM_UPDATE_ITER)
    if set(card['tables']) != set(cpu['tables']):
        raise AssertionError('phase 8 small: card and CPU results keys '
                             'differ')
    if card['init_params'] != cpu['init_params']:
        raise AssertionError('phase 8 small: card and CPU grids differ')
    share = float(np.all(chosen_cn(card) == chosen_cn(cpu),
                         axis=(1, 2)).mean())
    log('phase 8 small (N=60, max copy number 4): grid of {} restarts; '
        'chosen solution card {} / CPU {}; share of segments whose chosen '
        'cn is equal {:.4f}; card workflow whole {:.3f} s, CPU {:.3f} s'
        .format(len(card['init_params']), chosen['card f32'],
                chosen['CPU f64'], share, whole['card f32'],
                whole['CPU f64']))
    if share < SAME_CN_SHARE:
        raise AssertionError('phase 8 small: the card\'s chosen copy number '
                             'differs from the CPU\'s on more than {:.0%} of '
                             'the segments'.format(1 - SAME_CN_SHARE))
    return expected + small_waves * NUM_EM_ITER * NUM_UPDATE_ITER


def bench_row(sim_id):
    """Every metric of ``sim_id``'s rows in the accuracy benchmark's
    checked-in results (the JAX package's fit at the default config)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'benchmark', 'ACCURACY_BENCH.json')
    with open(path) as f:
        bench = json.load(f)
    row = {}
    for section in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results',
                    'outlier_evaluation'):
        for entry in bench[section]:
            if entry['sim_id'] == sim_id:
                row.update((k, v) for k, v in entry.items() if k != 'sim_id')
    return row


def evaluation_metrics(evaluation):
    """{metric: value} over the evaluation's series."""
    metrics = {}
    for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results',
                 'outlier_evaluation'):
        metrics.update(evaluation[name].to_dict())
    return metrics


def sha256_prefix(values):
    data = np.ascontiguousarray(values, dtype=np.float64).tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def check_simulation(experiment):
    """The simulation equals the JAX package's for the same definition."""
    found = dict(N=experiment.N, breakpoints=len(experiment.breakpoints),
                 h=[float(v) for v in experiment.h],
                 x=sha256_prefix(experiment.x), l=sha256_prefix(experiment.l))
    want = dict(N=ACCURACY_SIM['N'], breakpoints=ACCURACY_SIM['breakpoints'],
                h=list(ACCURACY_SIM['h']), x=ACCURACY_SIM['x'],
                l=ACCURACY_SIM['l'])
    # h is frac * h_total, a rounding away from the decimals
    same_h = np.allclose(found['h'], want['h'], rtol=1e-12, atol=0.0)
    if not same_h or dict(found, h=None) != dict(want, h=None):
        raise AssertionError('phase 9: the simulation is not the JAX '
                             'package\'s: {} against {}'.format(found, want))
    return found


def phase_accuracy():
    """The simulate → fit → evaluate path at full width and depth: the
    accuracy benchmark's first simulation, the fit workflow over init's
    grid at the default depth, the evaluation against the truth held to the
    benchmark's row, and one fit seeded from the truth. Returns the
    fb_grouped and fb_chains launches."""
    import networkx
    import torch
    from remixt_tpu_torch import config as config_mod
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.simulations import pipeline as sim_pipeline

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, 'build', 'chip_smoke', 'accuracy')
    fresh_directory(root)
    sim_defs = sim_pipeline.create_simulations(
        os.path.join(here, 'benchmark', 'accuracy_sim_defs.yaml'), {}, None)
    params = sim_defs[ACCURACY_SIM['name']]
    experiment_file = os.path.join(root, 'experiment.pickle')
    times = {}
    t0 = time.time()
    sim_pipeline.simulate_experiment(experiment_file, None, params)
    times['simulate'] = time.time() - t0
    t0 = time.time()
    with open(experiment_file, 'rb') as f:
        experiment = pickle.load(f)
    times['experiment'] = time.time() - t0
    found = check_simulation(experiment)
    log('phase 9: {} simulated on the host, the JAX package\'s simulation: '
        '{}; {} chains; networkx {}'.format(
            ACCURACY_SIM['name'], json.dumps(found),
            len(list(experiment.chains)), networkx.__version__))

    config = {}
    num_em = config_mod.get_param(config, 'num_em_iter')
    num_vi = config_mod.get_param(config, 'num_update_iter')
    run = fit_workflow('phase 9', experiment_file, config, None, root)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    restarts = len(run['init_params'])
    if restarts != ACCURACY_SIM['restarts']:
        raise AssertionError('phase 9: init\'s grid has {} restarts, the '
                             'JAX package\'s {}'.format(
                                 restarts, ACCURACY_SIM['restarts']))
    waves = -(-restarts // WAVE)
    expected = waves * num_em * num_vi
    expect_launches('phase 9', run['launches'], 'fb_grouped', expected)
    best = check_results_tables('phase 9', run, config, experiment.N)
    check_rerun('phase 9', run)
    t0 = time.time()
    evaluation = sim_pipeline.evaluate_tables(experiment, run['tables'])
    times['evaluate'] = time.time() - t0

    stats = run['tables']['stats']
    log('phase 9: fit workflow at the defaults, {} EM x {} VI: grid of {} '
        'restarts in {} waves of {}, max_depth {}; fb_grouped launches {}; '
        'chosen solution {} with h {}; ELBOs {:.6g} to {:.6g}'.format(
            num_em, num_vi, restarts, waves, WAVE, json.dumps(sorted(
                {p['max_depth'] for p in run['init_params'].values()})),
            expected, best, np.array2string(run['fits'][best]['h'],
                                            precision=6),
            float(np.min(stats['elbo'])), float(np.max(stats['elbo']))))
    fit_s, waves_s = run['times']['fit'], sum(run['waves'])
    log('phase 9: wall s: simulate {:.3f}, experiment {:.3f}, init {:.3f}, '
        'fit {:.3f} (waves {:.3f}, decode and results {:.3f}), collate '
        '{:.3f}, evaluate {:.3f}; init to collate {:.3f}; per wave {}'.format(
            times['simulate'], times['experiment'], run['times']['init'],
            fit_s, waves_s, fit_s - waves_s, run['times']['collate'],
            times['evaluate'], run['times']['whole'],
            json.dumps([round(w, 3) for w in run['waves']])))
    log('phase 9: max_memory_allocated {:.3f} GB'.format(peak_gb))

    metrics, reference = evaluation_metrics(evaluation), bench_row(
        ACCURACY_SIM['name'])
    misses = []
    for name, value in metrics.items():
        bar = ACCURACY_BARS.get(name)
        line = '{:<36s} {:12.6f}  benchmark {:12.6f}'.format(
            name, value, reference[name])
        if bar is not None:
            ok = abs(value - reference[name]) <= bar
            line += '  bar ±{} {}'.format(bar, 'ok' if ok else 'MISS')
            if not ok:
                misses.append(name)
        log('phase 9: ' + line)
    if misses:
        raise AssertionError('phase 9: outside the benchmark\'s bars: '
                             '{}'.format(misses))

    # the restart whose h is nearest the truth (Euclidean), fitted once more
    # with its breakpoint posteriors seeded from the true breakpoint copy
    # number
    def distance(init_id):
        return float(np.linalg.norm(pipeline._restart_h_init(
            run['init_params'][init_id]) - experiment.h))
    nearest = min(run['init_params'], key=distance)
    reset_chain_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    fit = pipeline.fit(experiment, run['init_params'][nearest],
                       dict(config, optimal_initialization=True))
    torch.cuda.synchronize()
    optimal_s = time.time() - t0
    expect_launches('phase 9 optimal initialization', chain_launches(),
                    'fb_chains', num_em * num_vi)
    if not np.isfinite(fit['stats']['elbo']):
        raise AssertionError('phase 9: optimal initialization: non-finite '
                             'ELBO')
    tables = {}
    pipeline.store_fit_results(tables, experiment, fit, 'optimal')
    optimal = evaluation_metrics(sim_pipeline.evaluate_tables(
        experiment, tables, 'optimal'))
    log('phase 9: optimal initialization from restart {} (mode {}, h {}, '
        '{:.6f} from the truth): {} EM x {} VI through pipeline.fit in {:.3f} '
        's, fb_chains launches {}, ELBO {:.6g}, h {}'.format(
            nearest, run['init_params'][nearest]['mode_idx'],
            np.array2string(pipeline._restart_h_init(
                run['init_params'][nearest]), precision=6), distance(nearest),
            num_em, num_vi, optimal_s, num_em * num_vi, fit['stats']['elbo'],
            np.array2string(fit['h'], precision=6)))
    log('phase 9: optimal initialization evaluation ' + json.dumps(
        {k: round(v, 6) for k, v in optimal.items()}))
    return expected, num_em * num_vi


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from remixt_tpu_torch.device import resolve_device
    resolve_device('cuda')   # TF32 off

    smi = phase_environment()
    data = simulate(N_FULL, CN_MAX_FULL, EVENTS_FULL, CHAINS_FULL, seed=0)
    inputs = kernel_inputs(data, WAVE)
    spec, frames, static_exp, be_exp_b, cbi = inputs
    one = (spec, frames[0], static_exp, be_exp_b[0], cbi)
    grouped, grouped_messages = phase_kernel(inputs)
    chains, chains_messages = phase_kernel_chains('phase 2b', one)
    grouped_scaled = phase_kernel_scaled(inputs, grouped_messages)
    chains_scaled, _ = phase_kernel_chains('phase 2d', one, scaled=True,
                                           log_space=chains_messages)
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
    grouped['launches'] += phase_workflow(data)
    del data, batched_results, sequential_results
    accuracy_grouped, accuracy_chains = phase_accuracy()
    grouped['launches'] += accuracy_grouped
    chains['launches'] += accuracy_chains

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
