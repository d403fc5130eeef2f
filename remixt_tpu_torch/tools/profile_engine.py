"""Engine profiler: a ``torch.profiler`` trace of whole-genome sweeps.

Profiles ``--iters`` VI sweeps of the production problem, one restart by
default (``engine.variational_sweep``, the ``fb_chains`` kernel) or a
wave of ``--restarts`` restarts (``engine.variational_sweeps_restarts``,
``fb_grouped``), writes the Chrome trace (``export_chrome_trace``) to
``OUTDIR/trace.json`` and prints the ms per sweep and segments/s, timed
under the profiler. ``remixt_tpu_torch.tools.summarize_trace`` prints the
trace's top events. Run:

    python -m remixt_tpu_torch.tools.profile_engine --outdir build/trace [--n 6000] [--iters 5] [--restarts R]
"""

import argparse
import os
import time

from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.tools.problem import build_problem, restart_wave
from remixt_tpu_torch.tools.sweep_budget import profiled, sync


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--n', type=int, default=6000)
    ap.add_argument('--events', type=int, default=300)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--restarts', type=int, default=0,
                    help='trace the restart-batched sweep instead')
    ap.add_argument('--outdir', required=True)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec, params, state, _ = build_problem(args.n, args.events,
                                           device=device)
    if args.restarts:
        params, state = restart_wave(params, state, args.restarts)

        def sweep(s):
            return eng.variational_sweeps_restarts(spec, params, s, 1)
        per_call = args.restarts * spec.N
    else:
        def sweep(s):
            return eng.variational_sweep(spec, params, s)
        per_call = spec.N

    state = sweep(state)
    sync(device)

    with profiled(device) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state = sweep(state)
        sync(device)
        dt = (time.perf_counter() - t0) / args.iters

    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, 'trace.json')
    prof.export_chrome_trace(path)
    print('sweep: {:.1f} ms  ({:.0f} segments/s)'.format(
        dt * 1e3, per_call / dt))
    print('trace written to', path)
    return {'ms_per_sweep': dt * 1e3, 'segments_per_s': per_call / dt,
            'trace': path}


if __name__ == '__main__':
    main()
