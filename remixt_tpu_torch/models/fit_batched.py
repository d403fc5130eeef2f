"""Batched restart-grid fitting (torch).

Counterpart of ``remixt_tpu/models/fit_batched.py`` without device meshes.
The grid fits in waves of ``chunk_size`` restarts stacked on a leading
axis; every wave is padded to the full chunk size by repeating its last
restart (pads are discarded), so every wave runs at the same restart
extent. Each restart owns an RNG stream seeded identically, as the
sequential fit reseeds per restart.
"""

import logging

import numpy as np

from remixt_tpu_torch.models import em as em_mod
from remixt_tpu_torch.models import engine as eng

logger = logging.getLogger('remixt_tpu_torch.fit_batched')


def fit_restarts_batched(model, h_inits, divergence_weights, chunk_size=8):
    """Fit every restart of the grid in padded waves on one model.

    Args:
        model: a BreakpointModel whose spec will be (re)used
        h_inits: list of (M,) h initializations, one per restart
        divergence_weights: matching list of divergence weights
        chunk_size: restarts fitted together (the wave)

    Returns:
        list of per-restart dicts with params, state, elbo, elbo_diff.
    """
    num_restarts = len(h_inits)
    M = len(h_inits[0])
    model._ensure_spec(M)
    spec = model.spec

    results = []
    for begin in range(0, num_restarts, chunk_size):
        chunk = list(range(begin, min(begin + chunk_size, num_restarts)))
        R = len(chunk)
        padded = chunk + [chunk[-1]] * (chunk_size - R)
        logger.info('fitting restarts %d-%d batched', chunk[0], chunk[-1])

        params_b = eng.stack([
            spec.init_params(
                h_inits[r], divergence_weights[r],
                total_mask=model._total_likelihood_mask.astype(float),
                allele_mask=model._allele_likelihood_mask.astype(float))
            for r in padded])
        state_b = eng.stack(
            [spec.init_state(model._init_p_breakpoint())] * chunk_size)
        rngs = [np.random.RandomState(model.random_seed)
                for _ in range(chunk_size)]

        prev_elbo = eng.calculate_elbo_restarts(spec, params_b, state_b)
        elbo_diff = None

        for _ in range(model.num_em_iter):
            state_b = eng.variational_sweeps_restarts(
                spec, params_b, state_b, model.num_update_iter)

            if model.do_h_update:
                params_b, _ = em_mod.update_h_fused_batched(
                    spec, params_b, state_b, rngs)

            weights_lists = em_mod.param_sample_weights_all_batched(
                spec, state_b, model.likelihood_params)
            params_b, _, elbo = em_mod.update_params_fused_batched(
                spec, params_b, state_b, tuple(model.likelihood_params),
                model.likelihood_param_bounds, rngs,
                weights_lists=weights_lists)

            elbo_diff = elbo - prev_elbo
            prev_elbo = elbo

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
