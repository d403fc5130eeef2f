"""The port's objectives (ELBO, and the M-step's subsample expected log
likelihood with its gradient in h) against the JAX engine, in float64 on
the CPU, on the problems and carried-across states of
``test_torch_engine.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.models import engine as jeng
from remixt_tpu_torch.models import engine as teng

from test_torch_engine import CASES, SCALES, build, port

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)


@pytest.mark.parametrize('case', range(len(CASES)))
@pytest.mark.parametrize('which', ['initial', 'swept'])
def test_elbo_matches(case, which):
    jspec, tspec, params_b, state_b, swept_b = build(case)
    s_b = state_b if which == 'initial' else swept_b
    ref = jax.jit(functools.partial(jeng.calculate_elbo_restarts, jspec))(
        params_b, s_b)
    got = teng.calculate_elbo_restarts(
        tspec, port(params_b, 'params'), port(s_b, 'state'))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9)


@pytest.mark.parametrize('case', range(len(CASES)))
def test_expected_log_likelihood_indexed_value_and_grad(case):
    jspec, tspec, params_b, _, swept_b = build(case)
    rng = np.random.RandomState(case)
    idx = np.stack([rng.choice(jspec.N, size=5, replace=False)
                    for _ in SCALES])

    def one(p, s, i):
        return jax.value_and_grad(lambda h: jeng.expected_log_likelihood_indexed(
            jspec, p._replace(h=h), s, i))(p.h)

    ref_val, ref_grad = jax.jit(jax.vmap(one))(
        params_b, swept_b, jnp.asarray(idx))

    tparams = port(params_b, 'params')
    h = tparams.h.clone().requires_grad_(True)
    val = teng.expected_log_likelihood_indexed(
        tspec, tparams._replace(h=h), port(swept_b, 'state'),
        torch.as_tensor(idx))
    (grad,) = torch.autograd.grad(val.sum(), h)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(ref_val),
                               rtol=1e-9)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-9)
