"""The port's special functions (``remixt_tpu_torch/ops/special.py``)
against the JAX package's, in float32 and float64, on the same inputs made
with numpy. Tolerances: rtol 1e-12 in float64, 1e-6 in float32 (torch's and
XLA's lgamma, exp and log differ in the last bits). The log pmfs are sums
of lgammas that cancel, so their tolerance is relative to the largest
lgamma term: atol = rtol * max|lgamma|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.ops import special as jsp
from remixt_tpu_torch.ops import special as tsp

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

DTYPES = [(np.float32, torch.float32, jnp.float32, 1e-6),
          (np.float64, torch.float64, jnp.float64, 1e-12)]


def both(fn_name, *arrays, np_dtype, t_dtype, j_dtype, **kwargs):
    ref = getattr(jsp, fn_name)(
        *[jnp.asarray(a.astype(np_dtype), dtype=j_dtype) for a in arrays],
        **kwargs)
    got = getattr(tsp, fn_name)(
        *[torch.as_tensor(a.astype(np_dtype), dtype=t_dtype) for a in arrays],
        **{('dim' if k == 'axis' else k): v for k, v in kwargs.items()})
    assert got.dtype == t_dtype
    return got.numpy(), np.asarray(ref)


def lgamma_scale(args):
    return float(torch.lgamma(torch.as_tensor(args)).abs().max())


def inputs(seed):
    rng = np.random.RandomState(seed)
    return rng, dict(
        logits=rng.randn(7, 11) * 30.0,
        probs=np.where(rng.rand(5, 9) < 0.2, 0.0, rng.rand(5, 9)))


@pytest.mark.parametrize('np_dtype,t_dtype,j_dtype,rtol', DTYPES)
@pytest.mark.parametrize('fn_name,kwargs', [
    ('logsumexp', dict(axis=-1)), ('logsumexp', dict(axis=0)),
    ('exp_normalize', dict(axis=-1))])
def test_log_space(np_dtype, t_dtype, j_dtype, rtol, fn_name, kwargs):
    _, x = inputs(0)
    got, ref = both(fn_name, x['logits'], np_dtype=np_dtype,
                    t_dtype=t_dtype, j_dtype=j_dtype, **kwargs)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)


@pytest.mark.parametrize('np_dtype,t_dtype,j_dtype,rtol', DTYPES)
def test_logsumexp_all_neg_inf(np_dtype, t_dtype, j_dtype, rtol):
    x = np.full((2, 4), -np.inf)
    got, ref = both('logsumexp', x, np_dtype=np_dtype, t_dtype=t_dtype,
                    j_dtype=j_dtype)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('np_dtype,t_dtype,j_dtype,rtol', DTYPES)
def test_plogp(np_dtype, t_dtype, j_dtype, rtol):
    _, x = inputs(1)
    got, ref = both('plogp', x['probs'], np_dtype=np_dtype, t_dtype=t_dtype,
                    j_dtype=j_dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)


@pytest.mark.parametrize('np_dtype,t_dtype,j_dtype,rtol', DTYPES)
def test_negbin_log_likelihood(np_dtype, t_dtype, j_dtype, rtol):
    rng, _ = inputs(2)
    x = np.floor(rng.rand(50) * 500.0)
    mu = rng.rand(50) * 400.0 + 1.0
    r = rng.rand(50) * 100.0 + 0.5
    got, ref = both('negbin_log_likelihood', x, mu, r, np_dtype=np_dtype,
                    t_dtype=t_dtype, j_dtype=j_dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * lgamma_scale(x + r))


@pytest.mark.parametrize('np_dtype,t_dtype,j_dtype,rtol', DTYPES)
def test_betabin_log_likelihood(np_dtype, t_dtype, j_dtype, rtol):
    rng, _ = inputs(3)
    n = np.floor(rng.rand(50) * 300.0) + 1.0
    k = np.floor(rng.rand(50) * n)
    p = rng.rand(50) * 0.9 + 0.05
    M = rng.rand(50) * 500.0 + 1.0
    got, ref = both('betabin_log_likelihood', k, n, p, M, np_dtype=np_dtype,
                    t_dtype=t_dtype, j_dtype=j_dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * lgamma_scale(n + M))


@pytest.mark.parametrize('np_dtype,t_dtype,j_dtype,rtol', DTYPES)
@pytest.mark.parametrize('n_range', [(0.0, 255.0), (256.0, 3e5)])
def test_lgamma_shift(np_dtype, t_dtype, j_dtype, rtol, n_range):
    """Both branches: the plain difference below n = 256 and the
    Stirling form above it."""
    rng, _ = inputs(4)
    n = np.floor(rng.uniform(*n_range, size=60))
    a = rng.rand(60) * 2000.0 + 0.5
    got, ref = both('lgamma_shift', n, a, np_dtype=np_dtype,
                    t_dtype=t_dtype, j_dtype=j_dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)


def test_lgamma_shift_f32_is_cancellation_free():
    """At whole-genome read counts the float32 Stirling branch stays close
    to the float64 difference, where the plain float32 difference of two
    ~2e6 lgammas does not."""
    n = np.array([2e5, 5e5, 1e6])
    a = np.array([500.0, 10.0, 1500.0])
    exact = (torch.lgamma(torch.as_tensor(n + a))
             - torch.lgamma(torch.as_tensor(n + 1.0))).numpy()
    got = tsp.lgamma_shift(torch.as_tensor(n, dtype=torch.float32),
                           torch.as_tensor(a, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-5)


@pytest.mark.parametrize('fn_name', ['plogp', 'lgamma_shift'])
def test_gradients_are_finite_at_guarded_points(fn_name):
    """The double-where guards keep autograd free of NaNs at p = 0 and in
    the unused lgamma_shift branch."""
    if fn_name == 'plogp':
        x = torch.tensor([0.0, 0.3, 1.0], dtype=torch.float64,
                         requires_grad=True)
        y = tsp.plogp(x)
    else:
        x = torch.tensor([0.5, 10.0, 1e5], dtype=torch.float64,
                         requires_grad=True)
        y = tsp.lgamma_shift(torch.tensor([0.0, 100.0, 1e6],
                                          dtype=torch.float64), x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all()
