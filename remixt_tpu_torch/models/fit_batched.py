"""Batched restart-grid fitting (torch).

Counterpart of ``remixt_tpu/models/fit_batched.py``. The grid fits in
waves of ``chunk_size`` restarts stacked on a leading axis; every wave is
padded to the full chunk size by repeating its last restart (pads are
discarded), so every wave runs at the same restart extent. Each restart
owns an RNG stream seeded identically, as the sequential fit reseeds per
restart.

With a device mesh (``parallel/distributed.Mesh``), each wave splits over
the mesh's restart axis: every sweep and EM update runs per restart shard
on the shard's replica of the spec (``parallel/restarts.py``), at the
shard's restart extent, so each restart's result is the single-device
fit's at that extent. A mesh with a chain axis also splits every shard's
chains over its row of that axis (``parallel/chain.py``), each group
through the spec's chain route (the kernel, or the plain scan).
"""

import logging

import numpy as np

from remixt_tpu_torch.models import em as em_mod
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.parallel import chain as par_chain
from remixt_tpu_torch.parallel import restarts as par

logger = logging.getLogger('remixt_tpu_torch.fit_batched')


def fit_restarts_batched(model, h_inits, divergence_weights, chunk_size=8,
                         mesh=None):
    """Fit every restart of the grid in padded waves on one model.

    Args:
        model: a BreakpointModel whose spec will be (re)used
        h_inits: list of (M,) h initializations, one per restart
        divergence_weights: matching list of divergence weights
        chunk_size: restarts fitted together (the wave)
        mesh: optional device mesh, every device this process's; a
            restart extent × chain extent of 1 or less means none.
            Otherwise the wave is rounded up to a multiple of the restart
            extent and split over it, and a chain extent above 1 splits
            each shard's chains over its chain devices.

    Returns:
        list of per-restart dicts with params, state, elbo, elbo_diff, in
        grid order, on the model's device.
    """
    num_restarts = len(h_inits)
    M = len(h_inits[0])
    model._ensure_spec(M)
    spec = model.spec

    restart_extent = chain_extent = 1
    if mesh is not None:
        restart_extent = mesh.shape.get('restart', 1)
        chain_extent = mesh.shape.get('chain', 1)
    if restart_extent * chain_extent <= 1:
        mesh = None
    else:
        if len(mesh.addressable_devices) != mesh.size:
            raise ValueError('a fit\'s mesh must hold this process\'s '
                             'devices only: {}'.format(mesh))
        chunk_size = (-(-max(chunk_size, restart_extent) // restart_extent)
                      * restart_extent)
        if chain_extent > 1:
            par_chain.enable_chain_sharding(spec, mesh)
        par.replicate_spec(mesh, spec)
    try:
        return _fit_waves(model, spec, h_inits, divergence_weights,
                          chunk_size, mesh)
    finally:
        if mesh is not None:
            par_chain.enable_chain_sharding(spec, None)
            mesh.replicas.pop(spec, None)


def _fit_waves(model, spec, h_inits, divergence_weights, chunk_size, mesh):
    sweeps = par.spec_fn(mesh, eng.variational_sweeps_restarts, 2)
    elbo_of = par.spec_fn(mesh, eng.calculate_elbo_restarts, 2)

    def whole(tree):
        return tree if mesh is None else par.gather(tree, spec.device)

    results = []
    for begin in range(0, len(h_inits), chunk_size):
        chunk = list(range(begin, min(begin + chunk_size, len(h_inits))))
        R = len(chunk)
        logger.info('fitting restarts %d-%d batched%s', chunk[0], chunk[-1],
                    '' if mesh is None else ' on {}'.format(mesh))

        params_b = par.pad_restarts(eng.stack([
            spec.init_params(
                h_inits[r], divergence_weights[r],
                total_mask=model._total_likelihood_mask.astype(float),
                allele_mask=model._allele_likelihood_mask.astype(float))
            for r in chunk]), chunk_size)
        state_b = eng.stack(
            [spec.init_state(model._init_p_breakpoint())] * chunk_size)
        rngs = [np.random.RandomState(model.random_seed)
                for _ in range(chunk_size)]
        if mesh is not None:
            params_b = par.shard_restarts(mesh, params_b)
            state_b = par.shard_restarts(mesh, state_b)

        prev_elbo = whole(elbo_of(spec, params_b, state_b))
        elbo_diff = None

        for _ in range(model.num_em_iter):
            state_b = sweeps(spec, params_b, state_b, model.num_update_iter)

            if model.do_h_update:
                params_b, _ = em_mod.update_h_fused_batched(
                    spec, params_b, state_b, rngs, mesh=mesh)

            weights_lists = em_mod.param_sample_weights_all_batched(
                spec, state_b, model.likelihood_params, mesh=mesh)
            params_b, _, elbo = em_mod.update_params_fused_batched(
                spec, params_b, state_b, tuple(model.likelihood_params),
                model.likelihood_param_bounds, rngs,
                weights_lists=weights_lists, mesh=mesh)

            elbo = whole(elbo)
            elbo_diff = elbo - prev_elbo
            prev_elbo = elbo

        params_b, state_b = whole(params_b), whole(state_b)
        prev_elbo = prev_elbo.cpu().numpy().astype(float)[:R]
        elbo_diff = (np.zeros(R) if elbo_diff is None
                     else elbo_diff.cpu().numpy().astype(float)[:R])

        for i in range(R):
            results.append({
                'params': eng.take(params_b, i),
                'state': eng.take(state_b, i),
                'elbo': float(prev_elbo[i]),
                'elbo_diff': float(elbo_diff[i]),
            })
    return results
