"""The port's engine (``remixt_tpu_torch.models.engine``) against the JAX
engine, field by field, in float64 on the CPU.

Problems are ``helpers.make_problem`` sized. State is carried across from
JAX with ``models/convert.py``: a JAX restart batch is swept once in JAX,
converted, and swept once more by both engines. The JAX engine takes its
CPU scan path there; the port takes the kernel path's structure (one
exp-space bank per sweep), whose chain kernel on the CPU is its plain
version.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.models import engine as jeng
from remixt_tpu.parallel.restarts import stack_pytrees
from remixt_tpu_torch.models import convert
from remixt_tpu_torch.models import engine as teng

from helpers import make_problem

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)


CASES = [
    dict(N=12, M=2, cn_max=2, num_breakpoints=2),
    dict(N=10, M=3, cn_max=2, num_breakpoints=1),
    dict(N=12, M=2, cn_max=3, num_breakpoints=0),
    dict(N=10, M=2, cn_max=2, num_breakpoints=2, normal_contamination=False),
    dict(N=14, M=2, cn_max=2, num_breakpoints=2, num_telomeres=3),
]
SCALES = (1.02, 0.97, 1.11)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


@functools.lru_cache(maxsize=None)
def build(case_idx):
    prob = make_problem(seed=case_idx, **CASES[case_idx])
    kwargs = dict(
        cn_states=prob['cn_states'], brk_states=prob['brk_states'],
        l=prob['l'], x=prob['x'], y=prob['y'],
        is_telomere=prob['is_telomere'],
        breakpoint_idx=prob['breakpoint_idx'],
        breakpoint_orient=prob['breakpoint_orient'],
        transition_penalty=prob['transition_penalty'],
        normal_contamination=prob['normal_contamination'])
    jspec = jeng.ModelSpec(dtype=jnp.float64, **kwargs)
    tspec = teng.ModelSpec(dtype=torch.float64, device='cpu', **kwargs)

    params = jspec.init_params(prob['h_init'], prob['divergence_weight'])
    params_b = stack_pytrees(
        [params._replace(h=params.h * s) for s in SCALES])
    state_b = stack_pytrees([jspec.init_state()] * len(SCALES))
    swept_b = jax.jit(functools.partial(
        jeng.variational_sweeps_restarts, jspec, num_sweeps=1))(
        params_b, state_b)
    return jspec, tspec, params_b, state_b, swept_b


def port(tree_b, kind):
    conv = (convert.params_from_numpy if kind == 'params'
            else convert.state_from_numpy)
    return conv(_np(tree_b), 'cpu', torch.float64)


@pytest.mark.parametrize('case', range(len(CASES)))
def test_spec_arrays_equal(case):
    jspec, tspec, *_ = build(case)
    for name in convert.SPEC_SIZES:
        assert getattr(tspec, name) == getattr(jspec, name), name
    for name, value in convert.spec_arrays(tspec).items():
        np.testing.assert_array_equal(
            value, np.asarray(getattr(jspec, name)), err_msg=name)


@pytest.mark.parametrize('case', range(len(CASES)))
def test_emissions_match(case):
    jspec, tspec, params_b, _, _ = build(case)
    ref_tot, ref_alle = jax.jit(jax.vmap(
        functools.partial(jeng.emission_tensors, jspec)))(params_b)
    got_tot, got_alle = teng.emission_tensors(tspec, port(params_b, 'params'))
    np.testing.assert_allclose(got_tot.numpy(), np.asarray(ref_tot),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got_alle.numpy(), np.asarray(ref_alle),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('case', range(len(CASES)))
def test_emissions_match_f32(case):
    """The float32 emission branch (cancellation-free lgamma_shift
    pairings). The planes sum lgamma terms of up to ~1e4 in float32, where
    torch's and XLA's lgamma differ by a few ulp, so the tolerance is
    absolute: 4e-3 nats."""
    prob = make_problem(seed=case, **CASES[case])
    kwargs = {k: prob[k] for k in (
        'cn_states', 'brk_states', 'l', 'x', 'y', 'is_telomere',
        'breakpoint_idx', 'breakpoint_orient', 'transition_penalty',
        'normal_contamination')}
    jspec = jeng.ModelSpec(dtype=jnp.float32, **kwargs)
    tspec = teng.ModelSpec(dtype=torch.float32, device='cpu', **kwargs)
    params = jspec.init_params(prob['h_init'], prob['divergence_weight'])
    params_b = stack_pytrees(
        [params._replace(h=params.h * s) for s in SCALES])
    ref = jax.jit(jax.vmap(
        functools.partial(jeng.emission_tensors, jspec)))(params_b)
    got = teng.emission_tensors(tspec, convert.params_from_numpy(
        _np(params_b), 'cpu', torch.float32))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=4e-3)


@pytest.mark.parametrize('case', range(len(CASES)))
def test_sweep_from_carried_state_matches(case):
    jspec, tspec, params_b, _, swept_b = build(case)
    ref = jax.jit(functools.partial(
        jeng.variational_sweeps_restarts, jspec, num_sweeps=1))(
        params_b, swept_b)
    got = teng.variational_sweeps_restarts(
        tspec, port(params_b, 'params'), port(swept_b, 'state'), 1)
    for name in ('posterior_marginals', 'p_breakpoint', 'p_outlier_total',
                 'p_outlier_allele', 'p_allele_swap'):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            atol=1e-9, err_msg=name)
    np.testing.assert_allclose(got.hmm_log_norm_const.numpy(),
                               np.asarray(ref.hmm_log_norm_const), rtol=1e-10)


def test_viterbi_decode_matches():
    jspec, tspec, params_b, _, swept_b = build(0)
    tparams = port(params_b, 'params')
    tstate = port(swept_b, 'state')
    decode = jax.jit(functools.partial(jeng.viterbi_decode, jspec))
    for r in range(len(SCALES)):
        ref_seq, ref_lp = decode(jax.tree.map(lambda x: x[r], params_b),
                                 jax.tree.map(lambda x: x[r], swept_b))
        seq, lp = teng.viterbi_decode(tspec, teng.take(tparams, r),
                                      teng.take(tstate, r))
        np.testing.assert_array_equal(seq.numpy(), np.asarray(ref_seq))
        np.testing.assert_allclose(float(lp), float(ref_lp), rtol=1e-10)
