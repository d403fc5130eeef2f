"""The port's single-restart fit (``remixt_tpu_torch.models.fit.
BreakpointModel.fit``) and its sweep and ELBO against the JAX package, in
float64 on the CPU, on ``test_fit.py``'s simulated problem (N=60, max copy
number 6, seed 11). The EM updates are in ``test_torch_em.py``.

State is carried across from JAX with ``models/convert.py``. Tolerances:
one sweep atol 1e-9 and the ELBO rtol 1e-9, as ``test_torch_engine.py``
and ``test_torch_objectives.py`` hold the batched engine; a 2 EM × 2 VI fit
h rtol 1e-7, ELBO rtol 1e-8, posteriors atol 1e-9, decoded copy number
exact, as ``test_pipeline.py`` holds batched against sequential.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.models import engine as jeng
from remixt_tpu.models.fit import BreakpointModel as JaxModel
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch.models import convert
from remixt_tpu_torch.models import engine as teng
from remixt_tpu_torch.models.fit import BreakpointModel
from remixt_tpu_torch.ops import fb_chains

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

MODEL_KWARGS = dict(max_copy_number=6, max_depth=1e9, min_segment_length=0.0,
                    min_proportion_genotyped=0.0, divergence_weight=1e-7,
                    random_seed=1234)
H_SCALE = np.array([1.05, 0.95, 1.02])


@pytest.fixture(scope='module')
def sim_data():
    return sim.simulate_experiment(N=60, M=3, h=(0.08, 0.05, 0.025),
                                   cn_max=6, negbin_r=2000., betabin_M=2000.,
                                   frac_genotyped=0.5, seed=11)


def jax_model(data, **kwargs):
    return JaxModel(data['x'], data['l'], data['adjacencies'],
                    data['breakpoints'], dtype=jnp.float64,
                    **dict(MODEL_KWARGS, **kwargs))


def port_model(data, **kwargs):
    return BreakpointModel(data['x'], data['l'], data['adjacencies'],
                           data['breakpoints'], dtype=torch.float64,
                           device='cpu', **dict(MODEL_KWARGS, **kwargs))


def fitted(model, data, num_em_iter=2, num_update_iter=2, **fit_kwargs):
    model.num_em_iter = num_em_iter
    model.num_update_iter = num_update_iter
    model.fit(data['h'] * H_SCALE, **fit_kwargs)
    return model


@pytest.fixture(scope='module')
def fits(sim_data):
    """(JAX model, port model), each after a 2 EM × 2 VI fit."""
    return fitted(jax_model(sim_data), sim_data), fitted(
        port_model(sim_data), sim_data)


def carried(jm, tm, which):
    """The JAX fit's params and its fitted ('fitted') or initial
    ('initial') state, as JAX trees and as the port's NamedTuples."""
    params = jm.params
    state = (jm.state if which == 'fitted'
             else jm.spec.init_state(jm._init_p_breakpoint()))
    return (params, state,
            convert.params_from_numpy(params, 'cpu', torch.float64),
            convert.state_from_numpy(state, 'cpu', torch.float64))


@pytest.mark.parametrize('which', ['initial', 'fitted'])
def test_variational_sweep_from_carried_state_matches(fits, which):
    jm, tm = fits
    jparams, jstate, tparams, tstate = carried(jm, tm, which)
    ref = jax.jit(functools.partial(jeng.variational_sweep, jm.spec))(
        jparams, jstate)
    before = fb_chains.LAUNCHES
    got = teng.variational_sweep(tm.spec, tparams, tstate)
    assert fb_chains.LAUNCHES == before   # CPU tensors: the plain version
    for name in ('posterior_marginals', 'framelogprob', 'p_breakpoint',
                 'p_outlier_total', 'p_outlier_allele', 'p_allele_swap'):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            atol=1e-9, err_msg=name)
    # messages: where they carry posterior mass (unreachable states clip to
    # different floors in the scan and the exp-space recursion)
    for name in ('alphas', 'betas'):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        significant = r > r.max(axis=-1, keepdims=True) - 60.0
        np.testing.assert_allclose(g[significant], r[significant], atol=1e-9,
                                   err_msg=name)
    np.testing.assert_allclose(float(got.hmm_log_norm_const),
                               float(ref.hmm_log_norm_const), rtol=1e-10)


@pytest.mark.parametrize('which', ['initial', 'fitted'])
def test_calculate_elbo_matches(fits, which):
    jm, tm = fits
    jparams, jstate, tparams, tstate = carried(jm, tm, which)
    ref = float(jax.jit(functools.partial(jeng.calculate_elbo, jm.spec))(
        jparams, jstate))
    got = teng.calculate_elbo(tm.spec, tparams, tstate)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-9)


def test_fit_matches_jax(fits):
    jm, tm = fits
    np.testing.assert_allclose(tm.h, np.asarray(jm.h), rtol=1e-7)
    np.testing.assert_allclose(tm.prev_elbo, jm.prev_elbo, rtol=1e-8)
    np.testing.assert_allclose(tm.prev_elbo_diff, jm.prev_elbo_diff,
                               rtol=1e-6)
    np.testing.assert_allclose(tm.state.posterior_marginals.numpy(),
                               np.asarray(jm.state.posterior_marginals),
                               atol=1e-9)
    for name, value in jm.get_likelihood_param_values().items():
        np.testing.assert_allclose(tm.get_likelihood_param_values()[name],
                                   value, rtol=1e-7, err_msg=name)
    cn_ref, brk_ref = jm.optimal_cn()
    cn, brk = tm.optimal_cn()
    np.testing.assert_array_equal(cn, cn_ref)
    assert set(brk) == set(brk_ref)
    for k in brk_ref:
        np.testing.assert_array_equal(brk[k], brk_ref[k])
    prob, prob_ref = tm.breakpoint_prob(), jm.breakpoint_prob()
    assert set(prob) == set(prob_ref)
    for k in prob_ref:
        np.testing.assert_allclose(prob[k], prob_ref[k], atol=1e-9)


def test_check_elbo_fit_runs(sim_data):
    """The stepwise path with the per-update ELBO guard (raises if any
    update lowers the ELBO)."""
    model = port_model(sim_data)
    model.check_elbo = True
    fitted(model, sim_data, num_em_iter=1, num_update_iter=2)
    assert np.isfinite(model.prev_elbo)
    assert np.all(np.isfinite(model.h))


def test_snapshot_resume_identical(sim_data, tmp_path):
    """A fit stopped after EM iteration 1 and resumed from its snapshot by
    a new model reaches the result of an uninterrupted 3-iteration fit."""
    ref = fitted(port_model(sim_data), sim_data, num_em_iter=3)
    snapshot = str(tmp_path / 'fit.ckpt')
    fitted(port_model(sim_data), sim_data, num_em_iter=1,
           snapshot_filename=snapshot)
    assert (tmp_path / 'fit.ckpt').exists()
    assert not (tmp_path / 'fit.ckpt.tmp').exists()
    resumed = fitted(port_model(sim_data), sim_data, num_em_iter=3,
                     snapshot_filename=snapshot)

    np.testing.assert_array_equal(resumed.h, ref.h)
    np.testing.assert_array_equal(resumed.state.posterior_marginals.numpy(),
                                  ref.state.posterior_marginals.numpy())
    assert resumed.prev_elbo == ref.prev_elbo
    cn, brk = resumed.optimal_cn()
    cn_ref, brk_ref = ref.optimal_cn()
    np.testing.assert_array_equal(cn, cn_ref)
    for k in brk_ref:
        np.testing.assert_array_equal(brk[k], brk_ref[k])


def test_reset_restart_masks_match_jax(sim_data):
    jm, tm = jax_model(sim_data), port_model(sim_data)
    depth = sim_data['x'][:, 2] / sim_data['l']
    for m in (jm, tm):
        m.prev_elbo = 1.0
        m.reset_restart(max_depth=float(np.median(depth)),
                        divergence_weight=1e-6)
        assert m.prev_elbo is None and m.divergence_weight == 1e-6
    np.testing.assert_array_equal(tm.total_likelihood_mask,
                                  jm.total_likelihood_mask)
    np.testing.assert_array_equal(tm.allele_likelihood_mask,
                                  jm.allele_likelihood_mask)
    assert 0 < tm.total_likelihood_mask.sum() < len(depth)
