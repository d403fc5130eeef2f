"""The measurement tools' problem: the JAX package's whole-genome
production problem (``bench.build_model`` / ``bench.build_problem``) built
by the port.

N segments (6000 at the default 500 kb grid), M=3 clones, max copy number
12 (S=355 states), ``num_events`` breakpoints, one chain per 260 segments
(23 at N=6000, the hg38 chromosome count), float32 on the device asked for.
"""

import numpy as np
import torch

from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.models.fit import BreakpointModel
from remixt_tpu_torch.simulations import simple as sim


def build_model(N, num_events, seed=0, device=None):
    """(model, data): a ``BreakpointModel`` at 5 EM × 5 VI and its
    simulation."""
    data = sim.simulate_experiment(
        N=N, M=3, h=(0.08, 0.05, 0.025), cn_max=12,
        num_events=num_events, seed=seed,
        num_chains=max(1, int(round(N / 260))))
    model = BreakpointModel(
        data['x'], data['l'], data['adjacencies'], data['breakpoints'],
        max_copy_number=12, max_depth=1e9,
        min_segment_length=1.0, min_proportion_genotyped=0.0,
        divergence_weight=1e-7, dtype=torch.float32, random_seed=1234,
        device=device)
    model.num_em_iter = 5
    model.num_update_iter = 5
    return model, data


def build_problem(N, num_events, seed=0, device=None):
    """(spec, params, state, data) of one restart at the true h."""
    model, data = build_model(N, num_events, seed=seed, device=device)
    spec = model._build_spec(3)
    params = spec.init_params(
        data['h'], 1e-7,
        total_mask=model._total_likelihood_mask.astype(float),
        allele_mask=model._allele_likelihood_mask.astype(float))
    state = spec.init_state()
    return spec, params, state, data


def restart_wave(params, state, num_restarts, seed=0):
    """``num_restarts`` copies of one restart stacked on a leading axis,
    each with its h scaled by its own factor in [1, 1.2), as the JAX tools
    stack theirs."""
    rng = np.random.RandomState(seed)
    params_b = eng.stack([params._replace(h=params.h * (1.0 + 0.2 * rng.rand()))
                          for _ in range(num_restarts)])
    return params_b, eng.stack([state] * num_restarts)
