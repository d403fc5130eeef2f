"""Restart-axis scaling probe of the restart-batched sweep.

Times the production 5-sweep block (``engine.variational_sweeps_restarts``)
at several wave sizes R and prints the aggregate segments/s and each grid
step's cost relative to the first R, after the single-restart sweep's
(``engine.variational_sweeps``, the ``fb_chains`` kernel): how the chain
kernel ``fb_grouped``, which takes any R in tiles of 8, and the sweep's
other parts scale with the restart axis. The last row names the
aggregate-throughput-optimal wave; the tool only reports it and changes no
default (``defaults.restart_chunk_size``). A wave that does not fit in
device memory is a row with its note; any other error stops the tool.

Each figure is the median over 3 timing loops of ``--iters`` blocks, host
clock ended by ``torch.cuda.synchronize()``. Prints one JSON row a line and
writes the rows only to ``--out``. Run:

    python -m remixt_tpu_torch.tools.probe_restart_scaling [R ...]   # default 1 2 4 8 12 16 24
    python -m remixt_tpu_torch.tools.probe_restart_scaling --device cpu --n 260 --events 10 1 2
"""

import argparse
import json
import time

import torch

from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.tools.problem import build_problem, restart_wave
from remixt_tpu_torch.tools.sweep_budget import device_record, sync

BLOCK = 5


def median_time(run, iters, repeats=3):
    """Median seconds per iteration over ``repeats`` loops of ``run(iters)``."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(iters)
        times.append((time.perf_counter() - t0) / iters)
    return sorted(times)[len(times) // 2]


def segments_per_s(block, state, num_segments, device, iters):
    """Segments/s of the sweeps of ``block(state)``, a block of ``BLOCK``
    sweeps; every log normalizer of the last block must be finite."""
    state0 = block(state)
    sync(device)
    last = []

    def run(n):
        s = state0
        for _ in range(n):
            s = block(s)
        sync(device)
        last[:] = [s]

    dt = median_time(run, iters) / BLOCK
    if not torch.isfinite(last[0].hmm_log_norm_const).all():
        raise RuntimeError('non-finite log normalizer')
    return num_segments / dt


def time_single_sweep(spec, params, state, device, iters=5):
    return segments_per_s(
        lambda s: eng.variational_sweeps(spec, params, s, BLOCK),
        state, spec.N, device, iters)


def time_restart_batched_sweep(spec, params, state, R, device, iters=5):
    params_b, state_b = restart_wave(params, state, R)
    return segments_per_s(
        lambda s: eng.variational_sweeps_restarts(spec, params_b, s, BLOCK),
        state_b, R * spec.N, device, iters)


def probe(spec, params, state, rs, device, iters=5):
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    single = time_single_sweep(spec, params, state, device, iters=iters)
    emit({'R': 0, 'note': 'single-restart sweep (fb_chains kernel)',
          'segments_per_s': round(single, 1)})
    base_r = rs[0]
    base_step_s = None
    best = (0.0, None)
    for r in rs:
        try:
            agg = time_restart_batched_sweep(spec, params, state, r, device,
                                             iters=iters)
        except torch.cuda.OutOfMemoryError as exc:
            torch.cuda.empty_cache()
            emit({'R': r, 'note': 'out_of_memory',
                  'error': str(exc).split('\n')[0][:200]})
            continue
        # aggregate throughput counts R x N segments a sweep, so r / agg
        # is proportional to the wall time of one grid step
        step_s = r / agg
        if base_step_s is None:
            base_step_s = step_s
        emit({'R': r, 'segments_per_s': round(agg, 1),
              'per_restart_segments_per_s': round(agg / r, 1),
              'step_cost_vs_R{}'.format(base_r): round(step_s / base_step_s,
                                                       2)})
        best = max(best, (agg, r))
    emit({'optimal_wave_R': best[1],
          'note': 'aggregate-throughput-optimal restart wave, reported '
                  'only: defaults.restart_chunk_size is not changed',
          'device': device_record(device)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('restarts', type=int, nargs='*',
                    default=[1, 2, 4, 8, 12, 16, 24])
    ap.add_argument('--n', type=int, default=6000)
    ap.add_argument('--events', type=int, default=300)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default=None, help='write the rows here too')
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec, params, state, _ = build_problem(args.n, args.events,
                                           device=device)
    rows = probe(spec, params, state, args.restarts, device,
                 iters=args.iters)
    if args.out is not None:
        with open(args.out, 'w') as f:
            json.dump(rows, f, indent=2)
            f.write('\n')
    return rows


if __name__ == '__main__':
    main()
