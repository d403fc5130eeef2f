"""Float32 accuracy gate of the port: how far the float32 engine strays
from float64 semantics at whole-genome width.

Counterpart of the JAX package's ``tools/accuracy_gate.py``, on the same
problem (N~6000 segments, S=355 states, M=3 clones, 300 breakpoints, 23
chains: ``make_problem``) and with the same figures:

  --oracle    the engine (``--dtype``, float32 by default) against a
              float64 reference, both running the same VI sweeps from one
              initialization; posterior max-abs-diff and the rest per
              sweep, ``ORACLE_GATE_THRESHOLDS`` held on the last sweep for
              a float32 engine. The reference is the port's numpy oracle
              (``models/oracle.py``, ``--reference oracle``), or the
              float64 engine on the same device (``--reference engine``),
              which on the card runs the float64 scan route in seconds
              where the oracle takes many minutes a sweep.
  --em        the float32 against the float64 single-restart fit, 5 EM x
              5 VI, both on the device: posteriors, q(brk), h, ELBO and
              the decoded copy number.
  --kernels   the float32 engine on the kernel route against the float32
              engine on the scan route (``use_kernels=False``), the same
              sweeps.

The device is CUDA unless ``--device cpu`` is given. Results print as JSON
lines; ``--out FILE`` also writes them to FILE as a JSON list. Run:

    python -m remixt_tpu_torch.tools.accuracy_gate \\
        --oracle --reference engine --em --kernels
    python -m remixt_tpu_torch.tools.accuracy_gate \\
        --oracle --n 300 --device cpu
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.models import states as states_mod
from remixt_tpu_torch.models.fit import BreakpointModel
from remixt_tpu_torch.models.oracle import OracleModel
from remixt_tpu_torch.ops import fb_chains, fb_grouped
from remixt_tpu_torch.simulations import simple as sim

# Thresholds the float32-vs-float64 gate must stay under (settled sweeps),
# those of the JAX package's gate. posterior: near-tied states legitimately
# move ~1e-2 in float32 (mean ~1e-7); p_outlier: growth past 1e-2 means
# the cancellation-free emission forms regressed.
ORACLE_GATE_THRESHOLDS = {
    'posterior_max_abs_diff': 5e-2,
    'posterior_argmax_disagreement': 1e-2,
    'p_outlier_total_max_abs_diff': 1e-2,
}


def make_problem(N=6000, num_events=300, seed=0, dtype='float32',
                 device=None, use_kernels=None, cn_max=12):
    """The whole-genome problem of the JAX gate: returns (model, data)."""
    data = sim.simulate_experiment(
        N=N, M=3, h=(0.08, 0.05, 0.025), cn_max=cn_max,
        num_events=num_events, seed=seed,
        num_chains=max(1, int(round(N / 260))))
    model = BreakpointModel(
        data['x'], data['l'], data['adjacencies'], data['breakpoints'],
        max_copy_number=cn_max, max_depth=1e9,
        min_segment_length=1.0, min_proportion_genotyped=0.0,
        divergence_weight=1e-7, dtype=dtype, random_seed=1234,
        device=device, use_kernels=use_kernels)
    model.num_em_iter = 5
    model.num_update_iter = 5
    return model, data


def initial(model, h_init):
    """The model's spec, its parameters at ``h_init`` and its initial
    state."""
    spec = model._build_spec(len(h_init))
    params = spec.init_params(
        h_init, model.divergence_weight,
        total_mask=model._total_likelihood_mask.astype(float),
        allele_mask=model._allele_likelihood_mask.astype(float))
    return spec, params, spec.init_state()


def build_oracle_for(model, h_init):
    """Float64 oracle over the model's (remapped) problem arrays."""
    M = len(h_init)
    cn_states_one = states_mod.enumerate_cn_states(
        M, 2, model.max_copy_number, model.max_copy_number_diff)
    cn_states = np.tile(cn_states_one[None], (model.N, 1, 1, 1))
    cn_states[:, :, 0, :] = model.normal_copies[:, None, :]
    cn_states = cn_states[model.seg_rev_remap]
    brk_states = states_mod.enumerate_brk_states(
        M, model.max_copy_number, model.max_copy_number_diff)

    oracle = OracleModel(
        num_clones=M,
        num_segments=model.N1,
        num_breakpoints=model.num_breakpoints,
        normal_contamination=model.normal_contamination,
        cn_states=cn_states,
        brk_states=brk_states,
        h_init=np.asarray(h_init, dtype=float),
        l=model.l1,
        x=model.x1[:, 2],
        y=model.x1[:, 0:2],
        is_telomere=model.is_telomere,
        breakpoint_idx=model.breakpoint_idx,
        breakpoint_orient=model.breakpoint_orient,
        transition_penalty=model.transition_log_prob,
        divergence_weight=model.divergence_weight,
    )
    oracle.total_likelihood_mask = (
        model._total_likelihood_mask.astype(np.int64))
    oracle.allele_likelihood_mask = (
        model._allele_likelihood_mask.astype(np.int64))
    return oracle


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.float64)


def max_abs_diff(a, b):
    return float(np.max(np.abs(as_numpy(a) - as_numpy(b))))


def sweep_diffs(state, ref):
    """The gate's figures for an engine state against a float64 reference
    (an oracle or an engine state) after the same sweeps."""
    marg, ref_marg = as_numpy(state.posterior_marginals), as_numpy(
        ref.posterior_marginals)
    ref_norm = float(as_numpy(ref.hmm_log_norm_const))
    return {
        'posterior_max_abs_diff': max_abs_diff(marg, ref_marg),
        'posterior_mean_abs_diff': float(np.mean(np.abs(marg - ref_marg))),
        # a large max-abs-diff on near-tied states is harmless iff the
        # decoded state agrees; this is the operative fraction
        'posterior_argmax_disagreement': float(np.mean(
            marg.argmax(axis=1) != ref_marg.argmax(axis=1))),
        'p_breakpoint_max_abs_diff': max_abs_diff(
            state.p_breakpoint, ref.p_breakpoint)
        if as_numpy(ref.p_breakpoint).size else 0.0,
        'p_outlier_total_max_abs_diff': max_abs_diff(
            state.p_outlier_total, ref.p_outlier_total),
        'log_norm_rel_diff': abs(float(as_numpy(state.hmm_log_norm_const))
                                 - ref_norm) / abs(ref_norm),
    }


def synchronize(device):
    if device.type == 'cuda':
        torch.cuda.synchronize()


def gate_oracle(N, num_sweeps=5, seed=0, dtype='float32', device=None,
                reference='oracle'):
    """Engine VI sweeps against float64 reference VI sweeps from the same
    initialization: the port's oracle, or the float64 engine on
    ``device``."""
    device = resolve_device(device)
    model, data = make_problem(N=N, seed=seed, dtype=dtype, device=device)
    h_init = data['h']
    spec, params, state = initial(model, h_init)

    if reference == 'oracle':
        ref = build_oracle_for(model, h_init)

        def reference_sweep(oracle):
            for update in ('update_p_allele_swap', 'update_p_cn',
                           'update_p_breakpoint', 'update_p_outlier_total',
                           'update_p_outlier_allele'):
                getattr(oracle, update)()
            return oracle
    elif reference == 'engine':
        ref_model, _ = make_problem(N=N, seed=seed, dtype='float64',
                                    device=device)
        ref_spec, ref_params, ref = initial(ref_model, h_init)

        def reference_sweep(ref_state):
            return eng.variational_sweep(ref_spec, ref_params, ref_state)
    else:
        raise ValueError('unknown reference {!r}'.format(reference))

    per_sweep = []
    for sweep in range(num_sweeps):
        t0 = time.time()
        ref = reference_sweep(ref)
        synchronize(device)
        t1 = time.time()
        state = eng.variational_sweep(spec, params, state)
        synchronize(device)
        diffs = sweep_diffs(state, ref)
        diffs['reference_seconds'] = t1 - t0
        diffs['engine_seconds'] = time.time() - t1
        per_sweep.append(diffs)
        print('sweep {}: {}'.format(sweep, json.dumps(diffs)), flush=True)

    return {
        'gate': '{}_engine_vs_f64_{}'.format(dtype, reference),
        'device': device.type,
        'N': int(spec.N), 'S': int(spec.S), 'M': int(len(h_init)),
        'K': int(spec.K), 'num_sweeps': num_sweeps,
        'posterior_max_abs_diff': max(
            d['posterior_max_abs_diff'] for d in per_sweep),
        'per_sweep': per_sweep,
    }


def kernel_launches():
    return (fb_grouped.LAUNCHES + fb_chains.LAUNCHES
            + fb_grouped.LAUNCHES_SCALED + fb_chains.LAUNCHES_SCALED)


def gate_em(N, seed=0, device=None):
    """float32 against float64 single-restart fit (5 EM x 5 VI with the EM
    updates), both on ``device``; wall time, EM iterations, peak device
    memory and kernel launches of each fit."""
    device = resolve_device(device)
    results = {}
    for dtype in ('float64', 'float32'):
        model, data = make_problem(N=N, seed=seed, dtype=dtype,
                                   device=device)
        if device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats()
        launches = kernel_launches()
        synchronize(device)
        t0 = time.time()
        model.fit(data['h'])
        synchronize(device)
        results[dtype] = {
            'model': model,
            'seconds': time.time() - t0,
            'launches': kernel_launches() - launches,
            'peak_gb': (torch.cuda.max_memory_allocated() / 1e9
                        if device.type == 'cuda' else None),
        }

    m32 = results['float32']['model']
    m64 = results['float64']['model']
    out = {
        'gate': 'f32_vs_f64_full_fit',
        'device': device.type,
        'N': int(m32.spec.N), 'S': int(m32.spec.S),
        'num_em_iter': m32.num_em_iter, 'num_update_iter': m32.num_update_iter,
        'posterior_max_abs_diff': max_abs_diff(
            m32.state.posterior_marginals, m64.state.posterior_marginals),
        'p_breakpoint_max_abs_diff': max_abs_diff(
            m32.state.p_breakpoint, m64.state.p_breakpoint),
        'h_max_rel_diff': float(np.max(
            np.abs(np.asarray(m32.h) - np.asarray(m64.h))
            / np.abs(np.asarray(m64.h)))),
        'elbo_f32': float(m32.prev_elbo),
        'elbo_f64': float(m64.prev_elbo),
        'elbo_rel_diff': abs(m32.prev_elbo - m64.prev_elbo) / abs(
            m64.prev_elbo),
    }
    for dtype, tag in (('float32', 'f32'), ('float64', 'f64')):
        out[tag + '_fit_seconds'] = results[dtype]['seconds']
        out[tag + '_em_iteration_seconds'] = (
            results[dtype]['seconds'] / results[dtype]['model'].num_em_iter)
        out[tag + '_peak_gb'] = results[dtype]['peak_gb']
        out[tag + '_kernel_launches'] = results[dtype]['launches']
    # the decode must agree where posteriors are confident
    cn32, _ = m32.optimal_cn()
    cn64, _ = m64.optimal_cn()
    out['decode_disagreement_fraction'] = float(
        np.mean(np.any(cn32 != cn64, axis=(1, 2))))
    return out


def gate_kernels(N, num_sweeps=5, seed=0, device=None):
    """float32 kernel route against float32 scan route, same sweeps from
    the same initialization."""
    device = resolve_device(device)
    model, data = make_problem(N=N, seed=seed, dtype='float32',
                               device=device)
    spec, params, state0 = initial(model, data['h'])

    states = {}
    for use_kernels in (False, True):
        spec.use_kernels = use_kernels
        state = state0
        for _ in range(num_sweeps):
            state = eng.variational_sweep(spec, params, state)
        synchronize(device)
        states[use_kernels] = state

    kernel, scan = states[True], states[False]
    return {
        'gate': 'kernels_vs_scan_f32',
        'device': device.type,
        'N': int(spec.N), 'S': int(spec.S), 'num_sweeps': num_sweeps,
        'posterior_max_abs_diff': max_abs_diff(
            kernel.posterior_marginals, scan.posterior_marginals),
        'p_breakpoint_max_abs_diff': max_abs_diff(
            kernel.p_breakpoint, scan.p_breakpoint),
        'log_norm_rel_diff': abs(
            float(kernel.hmm_log_norm_const) - float(scan.hmm_log_norm_const)
        ) / abs(float(scan.hmm_log_norm_const)),
    }


def check_thresholds(entry):
    """The float32 oracle gate's thresholds, on the settled state: the
    LAST sweep's diffs. Returns the failures."""
    if not entry.get('gate', '').startswith('float32_engine_vs_f64_'):
        return []
    last = entry['per_sweep'][-1]
    return ['{} = {:.3e} exceeds {:.0e}'.format(metric, last[metric], bound)
            for metric, bound in ORACLE_GATE_THRESHOLDS.items()
            if last.get(metric, 0.0) > bound]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--oracle', action='store_true')
    parser.add_argument('--em', action='store_true')
    parser.add_argument('--kernels', action='store_true')
    parser.add_argument('--reference', default='oracle',
                        choices=('oracle', 'engine'),
                        help='the float64 side of --oracle')
    parser.add_argument('--n', type=int, default=6000)
    parser.add_argument('--sweeps', type=int, default=5)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--dtype', default='float32',
                        choices=('float32', 'float64'))
    parser.add_argument('--device', default=None,
                        help='torch device (default: cuda)')
    parser.add_argument('--out', default=None,
                        help='also write the results to this JSON file')
    args = parser.parse_args(argv)

    entries = []
    if args.oracle:
        entries.append(gate_oracle(args.n, num_sweeps=args.sweeps,
                                   seed=args.seed, dtype=args.dtype,
                                   device=args.device,
                                   reference=args.reference))
    if args.em:
        entries.append(gate_em(args.n, seed=args.seed, device=args.device))
    if args.kernels:
        entries.append(gate_kernels(args.n, num_sweeps=args.sweeps,
                                    seed=args.seed, device=args.device))

    for entry in entries:
        print(json.dumps(entry), flush=True)
    if args.out is not None:
        with open(args.out, 'w') as f:
            json.dump(entries, f, indent=2)

    failures = [f for entry in entries for f in check_thresholds(entry)]
    if failures:
        print('GATE FAILURES:\n  ' + '\n  '.join(failures))
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
