"""Scaling measurement: segments/s of the restart-sharded sweep against
the device count (counterpart of ``tools/measure_scaling.py``).

Runs the restart-batched whole-genome sweep, sharded over the restart
axis (``parallel.restarts.make_sharded_sweep``), on nested sub-meshes of
the devices (the first 1, 2, 4, ... and all of them) and prints one JSON
row a sub-mesh with its segments/s. A row whose devices repeat a device
(virtual devices: one card, or the CPU, listed more than once) shares
that device among its shards: it is labelled ``meaningful: false`` and is
not a scaling measurement, as the JAX tool labels its CPU rows. The
restart count is rounded up to a multiple of each sub-mesh's size.

Each figure is the median over 3 timing loops of ``--iters`` sweeps,
host clock ended by a synchronise of every device.

``--fit`` times the production fit instead (``fit_restarts_batched``,
``--em-iter`` × ``--vi-iter``, the restarts in one wave) on the training
mesh of each sub-mesh (``make_training_mesh``: restart × chain), after a
warm-up fit of 1 EM × 1 VI; each row gives the fit's wall, its speedup
over the first row's (one device) and its ELBOs' largest relative
difference from that fit's.

Writes the result only to ``--out``. Run:

    python -m remixt_tpu_torch.tools.measure_scaling [--restarts R] [--n N]
    python -m remixt_tpu_torch.tools.measure_scaling --fit --restarts 16
    python -m remixt_tpu_torch.tools.measure_scaling --devices cuda:0 cuda:0
    python -m remixt_tpu_torch.tools.measure_scaling --devices cpu cpu --n 260 --events 10
"""

import argparse
import json
import time

import numpy as np
import torch

from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched
from remixt_tpu_torch.parallel import distributed
from remixt_tpu_torch.parallel import restarts as par
from remixt_tpu_torch.tools.accuracy_gate import initial, make_problem
from remixt_tpu_torch.tools.sweep_budget import device_record


def sync(devices):
    for device in set(devices):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)


def measure(devices, num_restarts, N, num_events, iters=5):
    """Segments/s of the restart-sharded sweep of ``num_restarts`` restarts
    (rounded up to a multiple of the device count) over ``devices``;
    returns (segments/s, restarts)."""
    model, data = make_problem(N=N, num_events=num_events,
                               device=devices[0])
    spec, params, state = initial(model, data['h'])
    R = -(-num_restarts // len(devices)) * len(devices)
    mesh = par.make_restart_mesh(devices)
    params_b = par.shard_restarts(mesh, eng.stack([
        params._replace(h=params.h * (1.0 + 0.01 * i)) for i in range(R)]))
    state_b = par.shard_restarts(mesh, eng.stack([state] * R))
    sweep = par.make_sharded_sweep(spec, mesh)

    out = sweep(params_b, state_b)
    sync(devices)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = sweep(params_b, out)
        sync(devices)
        times.append((time.perf_counter() - t0) / iters)
    for block in out.hmm_log_norm_const.blocks:
        if not torch.isfinite(block).all():
            raise RuntimeError('non-finite log normalizer')
    dt = sorted(times)[len(times) // 2]
    return R * spec.N / dt, R


def measure_fit(devices, num_restarts, N, num_events, em_iter, vi_iter):
    """The production fit of ``num_restarts`` restarts in one wave on the
    training mesh of ``devices`` (no mesh on one device); returns (wall
    in s, mesh shape, ELBOs)."""
    mesh = distributed.make_training_mesh(devices, num_restarts=num_restarts)

    def fit(num_em_iter, num_update_iter):
        model, data = make_problem(N=N, num_events=num_events,
                                   device=devices[0])
        model.num_em_iter, model.num_update_iter = num_em_iter, num_update_iter
        h_inits = [data['h'] * (1.0 + 0.01 * i) for i in range(num_restarts)]
        weights = [1e-7] * num_restarts
        sync(devices)
        t0 = time.perf_counter()
        results = fit_restarts_batched(model, h_inits, weights,
                                       chunk_size=num_restarts, mesh=mesh)
        sync(devices)
        return time.perf_counter() - t0, results

    fit(1, 1)
    wall, results = fit(em_iter, vi_iter)
    elbos = np.array([r['elbo'] for r in results])
    if not np.all(np.isfinite(elbos)):
        raise RuntimeError('non-finite ELBO')
    shape = {k: v for k, v in mesh.shape.items() if k != 'block'}
    return wall, shape, elbos


def nested_counts(n):
    """1, 2, 4, ... below ``n``, then ``n``."""
    counts = []
    c = 1
    while c < n:
        counts.append(c)
        c *= 2
    return counts + [n]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--restarts', type=int, default=12)
    ap.add_argument('--n', type=int, default=6000)
    ap.add_argument('--events', type=int, default=300)
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--devices', nargs='+', default=None,
                    help='devices, a name may repeat (default: every '
                         'local CUDA device)')
    ap.add_argument('--fit', action='store_true',
                    help='time the production fit, not the sweep')
    ap.add_argument('--em-iter', type=int, default=2)
    ap.add_argument('--vi-iter', type=int, default=5)
    ap.add_argument('--out', default=None, help='write the result here')
    args = ap.parse_args(argv)

    devices = ([resolve_device(d) for d in args.devices] if args.devices
               else distributed.local_cuda_devices())
    rows = []
    for count in nested_counts(len(devices)):
        sub = devices[:count]
        distinct = len(set(sub)) == len(sub)
        row = {'num_devices': count, 'devices': [str(d) for d in sub]}
        if args.fit:
            wall, shape, elbos = measure_fit(
                sub, args.restarts, args.n, args.events, args.em_iter,
                args.vi_iter)
            if not rows:
                one_device = (wall, elbos)
            row.update(mesh=shape, restarts=args.restarts, fit_s=wall,
                       speedup=one_device[0] / wall,
                       elbo_max_rel_diff=float(np.max(
                           np.abs(elbos - one_device[1])
                           / np.abs(one_device[1]))))
        else:
            segs, R = measure(sub, args.restarts, args.n, args.events,
                              iters=args.iters)
            row.update(restarts=R, segments_per_s=segs,
                       scaling_efficiency=(segs / rows[0]['segments_per_s']
                                           / count if rows else None))
        row['meaningful'] = distinct and sub[0].type == 'cuda'
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {
        'device': device_record(devices[0]),
        'meaningful': all(r['meaningful'] for r in rows),
        'note': ('restart-sharded whole-genome {}; rows with repeated or '
                 'CPU devices share one device and are not a scaling '
                 'measurement'.format(
                     'fit, {} EM x {} VI'.format(args.em_iter, args.vi_iter)
                     if args.fit else 'sweep')),
        'N': args.n,
        'rows': rows,
    }
    if args.out is not None:
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=2)
            f.write('\n')
    return out


if __name__ == '__main__':
    main()
