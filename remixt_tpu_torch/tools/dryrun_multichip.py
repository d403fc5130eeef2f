"""Multi-device dry run (counterpart of ``__graft_entry__.dryrun_multichip``).

On a list of devices (a device may repeat: virtual devices), at tiny
shapes:

1. the production restart-sharded fit (``models/fit_batched`` on the
   ``(restart, chain, block)`` mesh of ``parallel.distributed
   .make_training_mesh``), 2 EM × 2 VI, with a restart count that does not
   divide by the device count (the pad path);
2. a grid smaller than the device count on the restart × chain mesh it
   factors into;
3. restart 0 of (1) spot-checked against the single-device fit:
   posteriors within ``SPOT_BAR``;
4. the 2D (restart × chain) training step with an in-graph h step
   (``parallel.chain.make_2d_train_step``): finite expected log
   likelihoods;
5. one chain split into as many blocks as devices over a ``block`` mesh
   (``ops/fb_blocked.py``), its sweep against the chain-batched sweep in
   float64: posteriors within ``BLOCKED_BAR``.

Raises on any miss; prints one line a check and returns the figures. Run:

    python -m remixt_tpu_torch.tools.dryrun_multichip [--devices cuda:0 cuda:0 ...]
    python -m remixt_tpu_torch.tools.dryrun_multichip --devices cpu cpu cpu cpu
"""

import argparse
import json

import numpy as np
import torch

from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.models.fit import BreakpointModel
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched
from remixt_tpu_torch.parallel import chain as par_chain
from remixt_tpu_torch.parallel import distributed
from remixt_tpu_torch.parallel import restarts as par
from remixt_tpu_torch.simulations import simple as sim

# float32 reduction order across differing batch extents only
SPOT_BAR = 2e-4
# the JAX dry run's bound on the blocked sweep in float64
BLOCKED_BAR = 1e-8


def _model(data, cn_max, device, dtype):
    return BreakpointModel(
        data['x'], data['l'], data['adjacencies'], data['breakpoints'],
        max_copy_number=cn_max, max_depth=1e9, min_segment_length=1.0,
        min_proportion_genotyped=0.0, divergence_weight=1e-7, dtype=dtype,
        random_seed=1234, device=device)


def _build(N, M, cn_max, num_events, device, dtype, seed=0, num_chains=1):
    """(spec, params, state) of one restart at the simulation's h."""
    data = sim.simulate_experiment(
        N=N, M=M, h=(0.08, 0.05, 0.025)[:M], cn_max=cn_max,
        num_events=num_events, seed=seed, num_chains=num_chains)
    model = _model(data, cn_max, device, dtype)
    spec = model._build_spec(M)
    params = spec.init_params(
        data['h'], 1e-7,
        total_mask=model._total_likelihood_mask.astype(float),
        allele_mask=model._allele_likelihood_mask.astype(float))
    return spec, params, spec.init_state()


def _finite_elbos(label, fitted):
    elbos = [f['elbo'] for f in fitted]
    if not np.all(np.isfinite(elbos)):
        raise AssertionError('{}: non-finite ELBO {}'.format(label, elbos))


def dryrun_multichip(devices):
    """The dry run on ``devices`` (float32 but the blocked sweep's
    float64); returns its figures."""
    dtype = torch.float32
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    home = devices[0]
    out = {}

    # ---- the production path: the full EM fit restart-sharded ----------
    data = sim.simulate_experiment(
        N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=3, num_events=4, seed=7,
        num_chains=2)

    def build_model():
        model = _model(data, 3, home, dtype)
        model.num_em_iter = 2
        model.num_update_iter = 2
        return model

    R = n + n // 2
    h_inits = [data['h'] * (1.0 + 0.02 * i) for i in range(R)]
    weights = [1e-7] * R
    mesh = distributed.make_training_mesh(devices=devices)
    if mesh.shape['restart'] != n:
        raise AssertionError('mesh {} is not all restarts'.format(mesh))
    fitted = fit_restarts_batched(build_model(), h_inits, weights,
                                  chunk_size=2 * n, mesh=mesh)
    if len(fitted) != R:
        raise AssertionError('{} results for {} restarts'.format(
            len(fitted), R))
    _finite_elbos('the mesh-sharded production fit', fitted)
    print('production fit: {} restarts on {}'.format(R, mesh), flush=True)

    # ---- a grid smaller than the device count: restart x chain ----------
    R_small = max(1, n // 2)
    small = distributed.make_training_mesh(devices=devices,
                                           num_restarts=R_small)
    if small.shape['restart'] > R_small or small.size != n:
        raise AssertionError('small-grid mesh {}'.format(small))
    _finite_elbos('the small-grid 2D fit', fit_restarts_batched(
        build_model(), h_inits[:R_small], weights[:R_small],
        chunk_size=R_small, mesh=small))
    print('small-grid fit: {} restarts on {}'.format(R_small, small),
          flush=True)

    # ---- restart 0 against the single-device fit -------------------------
    ref = fit_restarts_batched(build_model(), h_inits[:1], weights[:1],
                               chunk_size=1)
    out['h_max_abs_diff'] = float((fitted[0]['params'].h
                                   - ref[0]['params'].h).abs().max())
    out['posterior_max_abs_diff'] = float(
        (fitted[0]['state'].posterior_marginals
         - ref[0]['state'].posterior_marginals).abs().max())
    print('production-fit mesh vs single-device: h max-abs-diff {:.3e}, '
          'posterior max-abs-diff {:.3e}'.format(
              out['h_max_abs_diff'], out['posterior_max_abs_diff']),
          flush=True)
    if not out['posterior_max_abs_diff'] < SPOT_BAR:
        raise AssertionError('the mesh-sharded production fit diverged')

    # ---- the 2D (restart x chain) training step -------------------------
    n_restart = 2 if n % 2 == 0 and n > 1 else 1
    n_chain = n // n_restart
    spec, params, state = _build(48, 3, 4, 4, home, dtype,
                                 num_chains=max(n_chain, 2))
    mesh2d = distributed.Mesh(
        np.asarray(devices, dtype=object).reshape(n_restart, n_chain),
        ('restart', 'chain'))
    params_b = eng.stack([params._replace(h=params.h * (1.0 + 0.01 * i))
                          for i in range(n_restart)])
    state_b = eng.stack([state] * n_restart)
    step = par_chain.make_2d_train_step(spec, mesh2d, h_step=1e-9)
    _, _, ell = step(params_b, state_b)
    ell = par.gather(ell, 'cpu')
    if not torch.isfinite(ell).all():
        raise AssertionError('non-finite ELL in the 2D step: {}'.format(ell))
    out['ell'] = ell.tolist()
    print('2D step on {}: ELL {}'.format(mesh2d, out['ell']), flush=True)

    # ---- one chain over a block mesh against the chain-batched sweep -----
    spec1, params1, state1 = _build(6 * n, 2, 3, 3, home, torch.float64)
    ref_state = eng.variational_sweep(spec1, params1, state1)
    block_mesh = distributed.Mesh(devices, ('block',))
    par_chain.enable_block_sharding(spec1, block_mesh, num_blocks=n)
    blk_state = eng.variational_sweep(spec1, params1, state1)
    par_chain.enable_block_sharding(spec1, None, num_blocks=1)
    if not torch.isfinite(blk_state.posterior_marginals).all():
        raise AssertionError('non-finite blocked posteriors')
    out['blocked_posterior_max_abs_diff'] = float(
        (ref_state.posterior_marginals
         - blk_state.posterior_marginals).abs().max())
    print('blocked intra-chain sweep vs chain-batched: posterior '
          'max-abs-diff {:.3e}'.format(
              out['blocked_posterior_max_abs_diff']), flush=True)
    if not out['blocked_posterior_max_abs_diff'] < BLOCKED_BAR:
        raise AssertionError('the blocked intra-chain sweep diverged from '
                             'the chain-batched sweep')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--devices', nargs='+', default=None,
                    help='devices, a name may repeat (default: every '
                         'local CUDA device)')
    args = ap.parse_args(argv)
    devices = (args.devices if args.devices
               else distributed.local_cuda_devices())
    out = dryrun_multichip(devices)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
