"""Per-phase budget of the port's warm full fit.

A full fit (5 EM × 5 VI, the h update, the 10-parameter grid zoom, the
decode) is not the raw sweep throughput: each EM iteration interleaves
device work with host work (the subsamples' draws) and one host pull (the
posterior sampling weights feed numpy's ``RandomState``). This tool times
each phase on its own, as ``sweep_budget`` times a sweep's parts.

The default: the single-restart fit cold (its first call) and warm, then
each of its phases at the fit's settled state as calls of their own (host
clock, ended by ``torch.cuda.synchronize()``), the same for the
restart-batched grid fit of ``--restarts`` restarts (``b_*``; 0 skips it).
These are upper bounds on each phase's share of the fit, where host work
overlaps device work wherever the data flow allows.

--trace: one warm production batched EM iteration (the calls
``fit_restarts_batched`` makes: the sweeps, ``update_h_fused_batched``,
``param_sample_weights_all_batched``, ``update_params_fused_batched``)
under ``torch.profiler``, its time split by the engine's ``sweep_*`` and
the M-step's ``em_*`` ranges (``EM_SCOPES``) as ``sweep_budget`` splits a
block: device time on the card, CPU self time under ``cpu`` keys on the
CPU.

The JAX tool's ``--no-cache`` and its ``compilation_cache`` key have no
counterpart: the port traces no graphs and keeps no compilation cache (its
kernels are built once, by ``ops/_build.py``).

Prints the JSON and writes it only to ``--out``. Run:

    python -m remixt_tpu_torch.tools.fit_budget [--n 6000] [--events 300] [--restarts 8]
    python -m remixt_tpu_torch.tools.fit_budget --trace [...]
    python -m remixt_tpu_torch.tools.fit_budget --device cpu --n 260 --events 10
"""

import argparse
import time

import numpy as np

from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.models import em as em_mod
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched
from remixt_tpu_torch.tools.problem import build_model
from remixt_tpu_torch.tools.sweep_budget import (
    attribute, device_record, profiled, sync, time_key, timeit, write_json)

EM_SCOPES = eng.SWEEP_RANGES + em_mod.EM_RANGES


def restart_grid(model, data, R):
    """The batched fit's inputs: R h initializations around the truth and
    their divergence weights, both from ``RandomState(1)``; the stacked
    params and (the single fit's) state; one RNG stream a restart."""
    rng = np.random.RandomState(1)
    h_inits = [data['h'] * (1.0 + 0.1 * rng.rand(3)) for _ in range(R)]
    dws = [10.0 ** -rng.randint(6, 9) for _ in range(R)]
    spec = model.spec
    params_b = eng.stack([
        spec.init_params(
            h, dw, total_mask=model._total_likelihood_mask.astype(float),
            allele_mask=model._allele_likelihood_mask.astype(float))
        for h, dw in zip(h_inits, dws)])
    state_b = eng.stack([model.state] * R)
    rngs = [np.random.RandomState(model.random_seed) for _ in range(R)]
    return h_inits, dws, params_b, state_b, rngs


def trace_em_iteration(model, data, R, device, iters=3):
    """Time attribution of one warm production batched EM iteration
    (sweeps, h update, weights, parameter grid zoom) by range."""
    model.fit(data['h'])  # the settled single state
    spec = model.spec
    names = tuple(model.likelihood_params)
    bounds = model.likelihood_param_bounds
    _, _, params_b, state_b, rngs = restart_grid(model, data, R)

    def em_iter(params_b, state_b):
        state_b = eng.variational_sweeps_restarts(
            spec, params_b, state_b, model.num_update_iter)
        params_b, _ = em_mod.update_h_fused_batched(
            spec, params_b, state_b, rngs)
        weights_lists = em_mod.param_sample_weights_all_batched(
            spec, state_b, names)
        params_b, _, elbo = em_mod.update_params_fused_batched(
            spec, params_b, state_b, names, bounds, rngs,
            weights_lists=weights_lists)
        return params_b, state_b, elbo

    params_b, state_b, _ = em_iter(params_b, state_b)
    sync(device)

    t0 = time.perf_counter()
    for _ in range(iters):
        em_iter(params_b, state_b)
    sync(device)
    wall_ms = (time.perf_counter() - t0) / iters * 1e3

    with profiled(device) as prof:
        for _ in range(iters):
            em_iter(params_b, state_b)
        sync(device)
    buckets, other, total = attribute(prof, EM_SCOPES, device)

    scale = 1e-3 / iters
    out = {'N': spec.N, 'restarts': R, 'mode': 'trace',
           'em_iter_wall_ms': round(wall_ms, 3),
           'em_iter_{}_ms'.format(time_key(device)): round(total * scale,
                                                           3)}
    for scope, us in buckets.items():
        out[scope + '_ms'] = round(us * scale, 3)
    out['unattributed_ms'] = round(other * scale, 3)
    out['device'] = device_record(device)
    return out


def phase_timings(model, data, R, device, iters=10):
    """The single fit cold and warm, its phases as calls of their own,
    and the same for the batched grid of R restarts."""
    out = {
        'N': model.N, 'restarts': R,
        # b_* figures scale with the restart batch: compare them only at
        # matching N and restarts
        'shape_note': 'b_* values are per-wave at this N/restarts; '
                      'not comparable across differing shapes',
        'device': device_record(device),
    }

    def ms(fn, n=iters):
        return round(timeit(fn, device, iters=n) * 1e3, 3)

    # ---- single-restart fit: total, then phases at the settled state ----
    for key in ('full_fit_cold_s', 'full_fit_warm_s'):
        sync(device)
        t0 = time.perf_counter()
        model.fit(data['h'])
        sync(device)
        out[key] = round(time.perf_counter() - t0, 3)

    spec, params, state = model.spec, model.params, model.state
    names = tuple(model.likelihood_params)
    bounds = model.likelihood_param_bounds
    rng = np.random.RandomState(7)

    # the floor of a host pull: one device scalar
    elbo_dev = eng.calculate_elbo(spec, params, state)
    sync(device)
    out['host_pull_scalar_ms'] = ms(lambda: float(elbo_dev), n=20)

    out['sweep5_ms'] = ms(lambda: eng.variational_sweeps(
        spec, params, state, model.num_update_iter))
    out['h_update_ms'] = ms(lambda: em_mod.update_h_fused(
        spec, params, state, rng))
    out['param_weights_ms'] = ms(lambda: em_mod.param_sample_weights_all(
        spec, state, names))
    weights_list = em_mod.param_sample_weights_all(spec, state, names)
    out['params_update_ms'] = ms(lambda: em_mod.update_params_fused(
        spec, params, state, names, bounds, rng, weights_list))
    out['elbo_ms'] = ms(lambda: eng.calculate_elbo(spec, params, state))
    out['decode_ms'] = ms(lambda: eng.viterbi_decode(spec, params, state))

    # ---- restart-batched grid fit ----
    if R > 0:
        h_inits, dws, params_b, state_b, rngs = restart_grid(model, data, R)
        for key in ('batched_grid_fit_cold_s', 'batched_grid_fit_warm_s'):
            sync(device)
            t0 = time.perf_counter()
            fit_restarts_batched(model, h_inits, dws, chunk_size=R)
            sync(device)
            out[key] = round(time.perf_counter() - t0, 3)

        state_b = eng.variational_sweeps_restarts(
            spec, params_b, state_b, model.num_update_iter)  # settled

        out['b_sweep5_ms'] = ms(lambda: eng.variational_sweeps_restarts(
            spec, params_b, state_b, model.num_update_iter))
        out['b_h_update_ms'] = ms(lambda: em_mod.update_h_fused_batched(
            spec, params_b, state_b, rngs))
        out['b_param_weights_ms'] = ms(
            lambda: em_mod.param_sample_weights_all_batched(
                spec, state_b, names))
        weights_lists = em_mod.param_sample_weights_all_batched(
            spec, state_b, names)
        out['b_params_update_ms'] = ms(
            lambda: em_mod.update_params_fused_batched(
                spec, params_b, state_b, names, bounds, rngs,
                weights_lists=weights_lists))
        out['b_elbo_ms'] = ms(lambda: eng.calculate_elbo_restarts(
            spec, params_b, state_b))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--n', type=int, default=6000)
    ap.add_argument('--events', type=int, default=300)
    ap.add_argument('--restarts', type=int, default=8)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--trace', action='store_true',
                    help='range attribution of one warm batched EM '
                         'iteration instead of the phase timings')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default=None, help='write the JSON here too')
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model, data = build_model(args.n, args.events, device=device)
    if args.trace:
        out = trace_em_iteration(model, data, args.restarts, device,
                                 iters=max(2, args.iters // 3))
    else:
        out = phase_timings(model, data, args.restarts, device,
                            iters=args.iters)
    write_json(out, args.out, indent=1)
    return out


if __name__ == '__main__':
    main()
