"""EM parameter updates (the M-step), restart-batched (torch).

Counterpart of the batched updates of ``remixt_tpu/models/em.py``:

* the haploid-depth update is backtracking gradient ascent on a
  per-restart subsample objective, with the gradient from
  ``torch.autograd`` and the 8 backtracking candidates evaluated as one
  batch axis, followed by a full-data accept/reject per restart;
* each scalar likelihood parameter is updated by a 3-level, 20-point grid
  zoom on its own subsample, with a per-component full-data accept/reject
  (``PARAM_COMPONENTS``).

Subsamples are drawn on the host from numpy ``RandomState`` streams with
the same draws as the JAX package, from weights computed on the device.

The single-restart updates the fit of one restart calls
(``update_h_fused``, ``update_params_fused``, ``param_sample_weights_all``)
are calls of the batched ones with a batch of one and a list of one RNG,
so both fits draw the same subsamples. ``update_h`` (scipy's L-BFGS-B),
``update_param`` (one parameter's grid zoom) and ``param_sample_weights``
(one parameter's weights) are the JAX package's stepwise alternatives.

With ``mesh=`` (a :class:`~remixt_tpu_torch.parallel.distributed.Mesh`)
the batched updates run per restart shard (``parallel/restarts.py``),
each shard on its replica of the spec, as the JAX updates shard_map over
the restart axis. The host draws every restart's subsamples in restart
order from its own stream, so they equal the unsharded fit's.

The fused updates' parts run inside ``torch.profiler.record_function``
ranges named as the JAX package's ``jax.named_scope`` (``EM_RANGES``),
disjoint siblings that enclose their Python loops whole
(``tools/fit_budget.py``).
"""

import logging

import numpy as np
import scipy.optimize
import torch
from torch.profiler import record_function

from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.parallel import restarts as par

logger = logging.getLogger('remixt_tpu_torch.em')


# grid-search refinement schedule: (points per level, zoom levels)
GRID_POINTS = 20
GRID_LEVELS = 3

# h update: outer ascent iterations, backtracking scales per iteration
H_OUTER = 12
H_SCALES = 8

# the profiler ranges of the M-step's parts
EM_RANGES = ('em_h_search', 'em_h_full_guard', 'em_running_components',
             'em_grid_zoom', 'em_candidate_guard', 'em_elbo_assembly')


def sample_size_for(num_segments):
    return max(int(min(200, num_segments / 10)), 1)


def create_sample_indices(rng, num_segments, weights=None):
    """Random segment subsample as a fixed-size index array."""
    return rng.choice(num_segments, size=sample_size_for(num_segments),
                      replace=False, p=weights)


def _h_update(spec, params_b, state_b, idx):
    """Backtracking gradient ascent on the subsample objective plus the
    full-data accept/reject; returns (params_b, accept (R,))."""
    h = params_b.h.detach()
    dtype = h.dtype
    rel_step = torch.full(h.shape[:1], 0.25, dtype=dtype, device=h.device)
    halvings = 0.5 ** torch.arange(H_SCALES, dtype=dtype, device=h.device)
    rows = torch.arange(h.shape[0], device=h.device)

    with record_function('em_h_search'):
        for _ in range(H_OUTER):
            h_leaf = h.clone().requires_grad_(True)
            with torch.enable_grad():
                val = eng.expected_log_likelihood_indexed(
                    spec, params_b._replace(h=h_leaf), state_b, idx)
                (g,) = torch.autograd.grad(val.sum(), h_leaf)
            val = val.detach()
            with torch.no_grad():
                gnorm = torch.linalg.norm(g, dim=-1) + 1e-12
                hnorm = torch.linalg.norm(h, dim=-1) + 1e-12
                scales = rel_step[:, None] * halvings             # (R, 8)
                step = (hnorm / gnorm)[:, None, None] * g[:, None, :]
                cands = torch.clamp(h[:, None, :] + scales[..., None] * step,
                                    1e-8, 10.0)                   # (R, 8, M)
                vals = eng.expected_log_likelihood_indexed(
                    spec, params_b._replace(h=cands), state_b, idx, extra=1)
                best = torch.argmax(vals, dim=-1)
                improved = vals[rows, best] > val
                h = torch.where(improved[:, None], cands[rows, best], h)
                rel_step = torch.where(
                    improved, torch.clamp(scales[rows, best] * 2.0, max=1.0),
                    rel_step * (0.5 ** H_SCALES))

    with torch.no_grad(), record_function('em_h_full_guard'):
        both = torch.stack([h, params_b.h], dim=1)                # (R, 2, M)
        full = eng.expected_log_likelihood_restarts(
            spec, params_b._replace(h=both), state_b, extra=1)
        accept = full[:, 0] >= full[:, 1]
        h_out = torch.where(accept[:, None], h, params_b.h)
    return params_b._replace(h=h_out), accept


def update_h_fused_batched(spec, params_b, state_b, rngs, mesh=None):
    """Restart-batched EM h update; one independent subsample per restart,
    drawn from that restart's RNG stream. With ``mesh``, per restart
    shard."""
    idx = torch.as_tensor(
        np.stack([create_sample_indices(rng, spec.N) for rng in rngs]),
        dtype=torch.long, device=spec.device if mesh is None else 'cpu')
    return par.spec_fn(mesh, _h_update, 3)(spec, params_b, state_b, idx)


# which emission components each scalar parameter touches: half 'total'
# components are the outlier planes u ∈ {0, 1}; half 'allele' components
# are k = v·2 + w ∈ {0..3}. Accept/reject recomputes only these planes.
PARAM_COMPONENTS = {
    'negbin_r_0': ('total', (0,)),
    'negbin_r_1': ('total', (1,)),
    'negbin_hdel_mu': ('total', (0, 1)),
    'negbin_hdel_r_0': ('total', (0,)),
    'negbin_hdel_r_1': ('total', (1,)),
    'betabin_M_0': ('allele', (0, 1)),
    'betabin_M_1': ('allele', (2, 3)),
    'betabin_loh_p': ('allele', (0, 1, 2, 3)),
    'betabin_loh_M_0': ('allele', (0, 1)),
    'betabin_loh_M_1': ('allele', (2, 3)),
}


@torch.no_grad()
def _params_update(spec, params_b, state_b, names, bounds, sample_idxs):
    """All scalar likelihood parameters in turn: grid zoom on the
    parameter's subsample, then per-component full-data accept/reject.
    Returns (params_b, accepts (R, P), (total_half, allele_half))."""
    dtype, device = spec.dtype, spec.device
    grid01 = torch.linspace(0.0, 1.0, GRID_POINTS, dtype=torch.float64,
                            device=device).to(dtype)
    rows = torch.arange(params_b.h.shape[0], device=device)

    running = {}
    with record_function('em_running_components'):
        for half, n_comp in (('total', 2), ('allele', 4)):
            vals = eng.expected_log_likelihood_components(
                spec, params_b, state_b, half, tuple(range(n_comp)))
            for c, v in enumerate(vals):
                running[(half, c)] = v

    accepts = []
    for i, name in enumerate(names):
        lo_c, hi_c = bounds[name]
        sub_idx = sample_idxs[:, i]
        half, comps = PARAM_COMPONENTS[name]
        current = getattr(params_b, name)
        lo = torch.full_like(current, lo_c)
        hi = torch.full_like(current, hi_c)
        best = current
        with record_function('em_grid_zoom'):
            for _ in range(GRID_LEVELS):
                values = lo[:, None] + (hi - lo)[:, None] * grid01  # (R, 20)
                objs = eng.expected_log_likelihood_indexed(
                    spec, params_b._replace(**{name: values}), state_b,
                    sub_idx, extra=1)
                best = values[rows, torch.argmax(objs, dim=-1)]
                step = (hi - lo) / (GRID_POINTS - 1)
                lo = torch.clamp(best - step, min=lo_c)
                hi = torch.clamp(best + step, max=hi_c)

        with record_function('em_candidate_guard'):
            cand_vals = eng.expected_log_likelihood_components(
                spec, params_b._replace(**{name: best}), state_b, half, comps)
            cand_sum = sum(cand_vals)
            run_sum = sum(running[(half, c)] for c in comps)
            accept = cand_sum >= run_sum
            params_b = params_b._replace(
                **{name: torch.where(accept, best, current)})
            for c, v in zip(comps, cand_vals):
                running[(half, c)] = torch.where(accept, v,
                                                 running[(half, c)])
        accepts.append(accept)

    halves = (running[('total', 0)] + running[('total', 1)],
              running[('allele', 0)] + running[('allele', 1)]
              + running[('allele', 2)] + running[('allele', 3)])
    return params_b, torch.stack(accepts, dim=1), halves


def _params_update_elbo(spec, params_b, state_b, sample_idxs, names,
                        bounds):
    """``_params_update`` and the ELBO of its result: (params_b, accepts,
    elbo_b)."""
    params_b, accepts, (tot_b, alle_b) = _params_update(
        spec, params_b, state_b, names, bounds, sample_idxs)
    with torch.no_grad(), record_function('em_elbo_assembly'):
        elbo_b = eng.calculate_elbo_from_halves_restarts(
            spec, params_b, state_b, tot_b, alle_b)
    return params_b, accepts, elbo_b


def update_params_fused_batched(spec, params_b, state_b, names, bounds, rngs,
                                weights_lists=None, mesh=None):
    """Restart-batched EM update of all scalar likelihood parameters and
    the ELBO of the result. ``weights_lists[r][i]`` are restart r's
    sampling weights for parameter i. With ``mesh``, per restart shard.
    Returns (params_b, accepts, elbo)."""
    k = sample_size_for(spec.N)
    idxs = np.empty((len(rngs), len(names), k), dtype=np.int64)
    for r, rng in enumerate(rngs):
        for i in range(len(names)):
            weights = (None if weights_lists is None
                       else weights_lists[r][i])
            idxs[r, i] = create_sample_indices(rng, spec.N, weights)
    idxs = torch.as_tensor(idxs,
                           device=spec.device if mesh is None else 'cpu')
    return par.spec_fn(mesh, _params_update_elbo, 3)(
        spec, params_b, state_b, idxs, tuple(names), bounds)


def _param_weights_all(spec, state_b, names):
    """(R, P, N) unnormalized sampling weights, one row per parameter."""
    marg = state_b.posterior_marginals
    pot = state_b.p_outlier_total
    poa = state_b.p_outlier_allele
    hdel = (marg * spec.is_hdel_plane.to(marg.dtype)).sum(dim=-1)
    loh = (marg * spec.is_loh_plane.to(marg.dtype)).sum(dim=-1)
    table = {
        'negbin_r_0': pot[..., 0],
        'negbin_r_1': pot[..., 1],
        'betabin_M_0': poa[..., 0],
        'betabin_M_1': poa[..., 1],
        'negbin_hdel_mu': hdel,
        'negbin_hdel_r_0': hdel * pot[..., 0],
        'negbin_hdel_r_1': hdel * pot[..., 1],
        'betabin_loh_p': loh,
        'betabin_loh_M_0': loh * poa[..., 0],
        'betabin_loh_M_1': loh * poa[..., 1],
    }
    return torch.stack([table[n] for n in names], dim=1)


def _normalize_weight_rows(w):
    out = []
    for row in w:
        norm = row.sum()
        out.append(row / norm if norm > 0.0 else None)
    return out


@torch.no_grad()
def param_sample_weights_all_batched(spec, state_b, names, mesh=None):
    """Posterior-responsibility sampling weights of every parameter for
    every restart: one device computation (per restart shard with
    ``mesh``) and one (R, P, N) host pull. Returns a list of R weight
    lists."""
    w_b = par.spec_fn(mesh, _param_weights_all, 1)(spec, state_b, names)
    if mesh is not None:
        w_b = par.gather(w_b, 'cpu')
    return [_normalize_weight_rows(w)
            for w in w_b.cpu().numpy().astype(np.float64)]


# ===========================================================================
# one restart
# ===========================================================================

def update_h_fused(spec, params, state, rng):
    """EM h update of one restart; returns (params, accept)."""
    params_b, accept = update_h_fused_batched(
        spec, eng.one(params), eng.one(state), [rng])
    return eng.take(params_b, 0), accept[0]


def update_params_fused(spec, params, state, names, bounds, rng,
                        weights_list=None):
    """EM update of one restart's scalar likelihood parameters and the ELBO
    of the result; returns (params, accepts (P,), elbo)."""
    params_b, accepts, elbo = update_params_fused_batched(
        spec, eng.one(params), eng.one(state), names, bounds, [rng],
        weights_lists=None if weights_list is None else [weights_list])
    return eng.take(params_b, 0), accepts[0], elbo[0]


def param_sample_weights_all(spec, state, names):
    """Sampling weights of every parameter for one restart (a list, None
    where a parameter's weights sum to zero)."""
    return param_sample_weights_all_batched(spec, eng.one(state), names)[0]


def param_sample_weights(spec, state, name):
    """One parameter's posterior-responsibility sampling weights, (N,)
    float64 on the host, or None where they sum to zero."""
    return param_sample_weights_all(spec, state, (name,))[0]


def update_h(spec, params, state, rng, h_bounds=(1e-8, 10.0)):
    """EM h update of one restart by scipy's L-BFGS-B on the subsample
    objective, its gradient from ``torch.autograd``, then the full-data
    accept/reject. Returns (params, accepted)."""
    idx = torch.as_tensor(create_sample_indices(rng, spec.N),
                          device=spec.device)[None]
    params_b, state_b = eng.one(params), eng.one(state)

    def objective(h):
        h_leaf = torch.as_tensor(h, dtype=spec.dtype, device=spec.device)
        h_leaf = h_leaf[None].requires_grad_(True)
        with torch.enable_grad():
            val = eng.expected_log_likelihood_indexed(
                spec, params_b._replace(h=h_leaf), state_b, idx)[0]
            (g,) = torch.autograd.grad(val, h_leaf)
        return -float(val.detach()), -g[0].cpu().numpy().astype(np.float64)

    h_before = params.h.cpu().numpy().astype(np.float64)
    with torch.no_grad():
        ell_before = float(eng.expected_log_likelihood(spec, params, state))
    result = scipy.optimize.minimize(
        objective, h_before, method='L-BFGS-B', jac=True,
        bounds=[h_bounds] * len(h_before))
    if not result.success:
        # the full-data accept/reject below guards against a bad step
        logger.info('h optimization inexact termination: %s', result.message)

    candidate = params._replace(h=torch.as_tensor(
        result.x, dtype=spec.dtype, device=spec.device))
    with torch.no_grad():
        ell_after = float(eng.expected_log_likelihood(spec, candidate, state))
    if ell_after < ell_before:
        return params, False
    return candidate, True


@torch.no_grad()
def update_param(spec, params, state, name, bounds, rng, weights=None):
    """EM update of one scalar likelihood parameter of one restart: a
    3-level, 20-point grid zoom on its subsample, then the full-data
    accept/reject. Returns (params, accepted)."""
    idx = torch.as_tensor(create_sample_indices(rng, spec.N, weights),
                          device=spec.device)[None]
    params_b, state_b = eng.one(params), eng.one(state)
    lo, hi = float(bounds[0]), float(bounds[1])
    for _ in range(GRID_LEVELS):
        values = np.linspace(lo, hi, GRID_POINTS)
        objs = eng.expected_log_likelihood_indexed(
            spec, params_b._replace(**{name: torch.as_tensor(
                values[None], dtype=spec.dtype, device=spec.device)}),
            state_b, idx, extra=1)[0]
        best = float(values[int(torch.argmax(objs))])
        step = (hi - lo) / (GRID_POINTS - 1)
        lo = max(float(bounds[0]), best - step)
        hi = min(float(bounds[1]), best + step)

    candidate = params._replace(**{name: torch.tensor(
        best, dtype=spec.dtype, device=spec.device)})
    ell_before = float(eng.expected_log_likelihood(spec, params, state))
    ell_after = float(eng.expected_log_likelihood(spec, candidate, state))
    if ell_after < ell_before:
        return params, False
    return candidate, True
