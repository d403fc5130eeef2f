"""The port's single-restart EM updates (``remixt_tpu_torch.models.em``) and
the single-restart objective pieces they use, against the JAX package, in
float64 on the CPU, on ``test_fit.py``'s simulated problem.

Both packages start from one state: the port's model after a 1 EM × 2 VI
fit, carried into JAX trees. Tolerances: sampling weights rtol 1e-12;
q(brk) atol 1e-9, as ``test_torch_engine.py`` holds the sweep; L-BFGS-B
h rtol 1e-6 (the two gradients agree to ~1e-10 relative, and the line
search's decisions may amplify that); the grid zoom's chosen value rtol
1e-12 (the same grid point). The expected log likelihood is held at rtol
1e-10: its emission planes agree with JAX's to ~1e-10 relative (torch's
and XLA's lgamma differ by a few ulp on arguments of ~1e4), and the port
sums a subsample over the selected segments where JAX weights all segments
by a 0/1 indicator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.models import em as jem
from remixt_tpu.models import engine as jeng
from remixt_tpu_torch.models import em as tem
from remixt_tpu_torch.models import engine as teng

from test_torch_fit import fitted, jax_model, port_model, sim_data  # noqa: F401

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

ALL_PARAMS = ('negbin_r_0', 'negbin_r_1', 'betabin_M_0', 'betabin_M_1',
              'negbin_hdel_mu', 'negbin_hdel_r_0', 'negbin_hdel_r_1',
              'betabin_loh_p', 'betabin_loh_M_0', 'betabin_loh_M_1')


def as_jax(tree, cls):
    return cls(**{k: jnp.asarray(v.numpy()) for k, v in
                  tree._asdict().items()})


@pytest.fixture(scope='module')
def models(sim_data):  # noqa: F811
    """(JAX model with its spec, port model), both holding the port's
    params and state after a 1 EM × 2 VI fit."""
    tm = fitted(port_model(sim_data), sim_data, num_em_iter=1)
    jm = jax_model(sim_data)
    jm.spec = jm._build_spec(3)
    jm.params = as_jax(tm.params, jeng.Params)
    jm.state = as_jax(tm.state, jeng.VState)
    return jm, tm


@pytest.mark.parametrize('which', ['initial', 'fitted'])
def test_update_p_breakpoint_builds_its_bank(models, which):
    """Without a bank the single-restart q(brk) update builds the one of
    p_breakpoint_used, or the ones bank before the first chain update."""
    jm, tm = models
    if which == 'initial':
        jstate = jm.spec.init_state()
        tstate = tm.spec.init_state()
    else:
        jstate, tstate = jm.state, tm.state
    ref = jeng.update_p_breakpoint(jm.spec, jm.params, jstate)
    got = teng.update_p_breakpoint(tm.spec, tm.params, tstate)
    np.testing.assert_allclose(got.p_breakpoint.numpy(),
                               np.asarray(ref.p_breakpoint), atol=1e-9)


def test_expected_log_likelihood_with_sample_matches(models):
    jm, tm = models
    sample = jem.create_sample(np.random.RandomState(3), jm.spec.N)
    for s in (None, sample):
        ref = float(jeng.expected_log_likelihood(
            jm.spec, jm.params, jm.state,
            None if s is None else jnp.asarray(s)))
        got = float(teng.expected_log_likelihood(tm.spec, tm.params,
                                                 tm.state, s))
        np.testing.assert_allclose(got, ref, rtol=1e-10)
    with pytest.raises(ValueError):
        teng.expected_log_likelihood(tm.spec, tm.params, tm.state,
                                     sample * 0.5)


@pytest.mark.parametrize('name', ALL_PARAMS)
def test_param_sample_weights_match(models, name):
    jm, tm = models
    ref = jem.param_sample_weights(jm.spec, jm.state, name)
    got = tem.param_sample_weights(tm.spec, tm.state, name)
    if ref is None:
        assert got is None
    else:
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_update_h_lbfgs_matches(models):
    jm, tm = models
    ref, ref_ok = jem.update_h(jm.spec, jm.params, jm.state,
                               np.random.RandomState(7))
    got, ok = tem.update_h(tm.spec, tm.params, tm.state,
                           np.random.RandomState(7))
    assert ok == ref_ok
    np.testing.assert_allclose(got.h.numpy(), np.asarray(ref.h), rtol=1e-6)


@pytest.mark.parametrize('name', ALL_PARAMS[:4])
def test_update_param_matches(models, name):
    jm, tm = models
    weights = jem.param_sample_weights(jm.spec, jm.state, name)
    bounds = jm.likelihood_param_bounds[name]
    ref, ref_ok = jem.update_param(jm.spec, jm.params, jm.state, name,
                                   bounds, np.random.RandomState(5), weights)
    got, ok = tem.update_param(tm.spec, tm.params, tm.state, name, bounds,
                               np.random.RandomState(5), weights)
    assert ok == ref_ok
    np.testing.assert_allclose(float(getattr(got, name)),
                               float(getattr(ref, name)), rtol=1e-12)


def test_fused_updates_match_batched_rows(models):
    """The single-restart fused EM updates are the batched ones at one
    restart: the same draws from the same RNG give the same result."""
    _, tm = models
    names = tuple(tm.likelihood_params)
    one, _ = tem.update_h_fused(tm.spec, tm.params, tm.state,
                                np.random.RandomState(4))
    batch, _ = tem.update_h_fused_batched(
        tm.spec, teng.stack([tm.params]), teng.stack([tm.state]),
        [np.random.RandomState(4)])
    np.testing.assert_array_equal(one.h.numpy(), batch.h[0].numpy())

    weights = tem.param_sample_weights_all(tm.spec, tm.state, names)
    one, accepts, elbo = tem.update_params_fused(
        tm.spec, tm.params, tm.state, names, tm.likelihood_param_bounds,
        np.random.RandomState(6), weights)
    assert accepts.shape == (len(names),) and elbo.shape == ()
    batch, _, elbo_b = tem.update_params_fused_batched(
        tm.spec, teng.stack([tm.params]), teng.stack([tm.state]), names,
        tm.likelihood_param_bounds, [np.random.RandomState(6)], [weights])
    for name in names:
        assert float(getattr(one, name)) == float(getattr(batch, name)[0])
    assert float(elbo) == float(elbo_b[0])
