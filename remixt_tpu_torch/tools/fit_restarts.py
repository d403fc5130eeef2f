"""Fit chosen restarts of one simulation of a simulation definition grid
and print each one's h, ELBO and a digest of its decoded copy number.

The simulation is made as the benchmark runner makes it
(``simulate_experiment``, read back from its pickle), its restart grid as
``init`` makes it at the config (``--config``, the defaults otherwise)
with ``--dtype`` as the engine dtype, and the restarts fit through
``fit_many``: together in one batched wave (``--batched``) or one at a
time. One JSON line per restart, then one with the fit's wall time and
the device. Run:

    python -m remixt_tpu_torch.tools.fit_restarts \\
        benchmark/accuracy_sim_defs.yaml accuracy_0_0 38 --dtype float64
    python -m remixt_tpu_torch.tools.fit_restarts \\
        benchmark/accuracy_sim_defs.yaml accuracy_0_0 \\
        32 33 34 35 36 37 38 39 --dtype float64 --batched
"""

import argparse
import hashlib
import json
import os
import pickle
import time

import numpy as np
import torch

from remixt_tpu_torch.analysis import pipeline
from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.simulations import pipeline as sim_pipeline


def cn_digest(cn):
    data = np.ascontiguousarray(cn, dtype=np.int64).tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('sim_defs', help='simulation definition YAML')
    parser.add_argument('sim_id')
    parser.add_argument('restarts', type=int, nargs='+')
    parser.add_argument('--dtype', default='float32',
                        choices=('float32', 'float64'))
    parser.add_argument('--batched', action='store_true')
    parser.add_argument('--config', default=None,
                        help='configuration YAML (the defaults otherwise)')
    parser.add_argument('--device', default=None,
                        help='torch device (default: cuda)')
    parser.add_argument('--work', default=os.path.join('build',
                                                       'fit_restarts'))
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    params = sim_pipeline.create_simulations(args.sim_defs, {}, None)[
        args.sim_id]
    os.makedirs(args.work, exist_ok=True)
    experiment_file = os.path.join(args.work, args.sim_id + '.pickle')
    sim_pipeline.simulate_experiment(experiment_file, None, params)
    with open(experiment_file, 'rb') as f:
        experiment = pickle.load(f)

    config = {}
    if args.config is not None:
        import yaml
        with open(args.config) as f:
            config = yaml.safe_load(f)
    config = dict(config, engine_dtype=args.dtype,
                  batch_restarts=args.batched)
    grid, _ = pipeline.init_tables(experiment, config)
    chosen = {i: grid[i] for i in args.restarts}
    if device.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.time()
    fits = pipeline.fit_many(experiment, chosen, config, device=device)
    if device.type == 'cuda':
        torch.cuda.synchronize()
    wall = time.time() - t0
    for init_id, fit in fits.items():
        print(json.dumps({'init_id': init_id, 'h': fit['h'].tolist(),
                          'elbo': float(fit['stats']['elbo']),
                          'cn': cn_digest(fit['cn'])}), flush=True)
    print(json.dumps({
        'sim_id': args.sim_id, 'dtype': args.dtype, 'batched': args.batched,
        'wall_seconds': wall, 'device': device.type,
        'device_name': (torch.cuda.get_device_name(0)
                        if device.type == 'cuda' else None)}), flush=True)


if __name__ == '__main__':
    main()
