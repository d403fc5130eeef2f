"""The port's chain scan (``remixt_tpu_torch/ops/fb_scan.py``), the
float64 route's chain forward-backward, on the CPU.

(a) ``forward_backward_chains`` and ``forward_backward_chains_restarts``
    against the JAX package's ``fb_scan`` functions in float64, on the same
    inputs, at ``helpers.make_problem`` shapes (``test_torch_engine.py``'s
    cases, and one with a transition penalty steep enough that messages
    underflow to ``-inf``): the same ``-inf`` entries, messages within atol
    1e-10 elsewhere, log_norm rtol 1e-12. XLA's CPU backend flushes
    subnormal numbers to zero, so the port runs with torch's flush on
    there: a sum that is subnormal in one and zero in the other would
    otherwise be finite in one and ``-inf`` in the other;
(b) ``build_restart_plan`` equals the JAX plan;
(c) the scan against the plain versions of the two log-space kernels
    (``fb_grouped``, ``fb_chains``), which floor the step at ``TINY``, on
    entries within 60 nats of the row maximum: float32 at the kernel
    tests' atol 2e-4 / rtol 1e-5, float64 at atol 1e-9;
(d) the engine's route: ``ModelSpec.use_kernels`` picks the scan or the
    kernel wrappers in both chain updates, and a float64 tensor that
    reaches a kernel wrapper raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.models import engine as jeng
from remixt_tpu.ops import fb_scan as jscan
from remixt_tpu_torch.models import engine as teng
from remixt_tpu_torch.ops import fb_chains, fb_grouped, fb_scan

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
    # steep transitions and frames spread over thousands of nats: states
    # whose every incoming path underflows go to -inf
    dict(N=12, M=2, cn_max=2, num_breakpoints=2, num_telomeres=2,
         transition_penalty=400.0),
]
STEEP = len(CASES) - 1
R = 3


@functools.lru_cache(maxsize=None)
def build(case_idx):
    """The JAX spec of the case and, from a seeded numpy generator, frames
    (R, N, S) and q(brk) (R, K, B)."""
    prob = make_problem(seed=case_idx, **CASES[case_idx])
    kwargs = {k: prob[k] for k in (
        'cn_states', 'brk_states', 'l', 'x', 'y', 'is_telomere',
        'breakpoint_idx', 'breakpoint_orient', 'transition_penalty',
        'normal_contamination')}
    jspec = jeng.ModelSpec(dtype=jnp.float64, **kwargs)
    rng = np.random.RandomState(100 + case_idx)
    frames = (-1600.0 if case_idx == STEEP else -8.0) * rng.rand(
        R, jspec.N, jspec.S)
    p_brk = rng.rand(R, max(jspec.K, 1), jspec.B)[:, :jspec.K]
    p_brk /= np.maximum(p_brk.sum(axis=-1, keepdims=True), 1e-300)
    return kwargs, jspec, frames, p_brk


def layout(jspec):
    return (np.asarray(jspec.chain_bank_idx), np.asarray(jspec.chain_seg_map),
            np.asarray(jspec.chain_last))


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.fixture
def flush_denormal():
    """Subnormals flushed to zero, as XLA's CPU backend does."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def assert_messages_equal(got, ref, log_norm, log_norm_ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], atol=1e-10, rtol=0)
    np.testing.assert_allclose(np.asarray(log_norm),
                               np.asarray(log_norm_ref), rtol=1e-12)


def single_inputs(case):
    _, jspec, frames, p_brk = build(case)
    bank = np.asarray(jeng.full_bank(jspec, jnp.asarray(p_brk[0])))
    return jspec, frames[0], bank


def restart_inputs(case):
    _, jspec, frames, p_brk = build(case)
    be_bank_b = np.asarray(jax.vmap(
        lambda pb: jeng.breakend_tmats(jspec, pb))(jnp.asarray(p_brk)))
    return jspec, frames, np.asarray(jspec.static_bank), be_bank_b


@pytest.mark.parametrize('case', range(len(CASES)))
def test_single_restart_scan_matches_jax(case, flush_denormal):
    jspec, frame, bank = single_inputs(case)
    cbi, seg, last = layout(jspec)
    ref = jscan.forward_backward_chains(jnp.asarray(frame), jnp.asarray(bank),
                                        cbi, seg, last)
    got = fb_scan.forward_backward_chains(
        t(frame), t(bank), t(cbi, torch.int32), t(seg, torch.long),
        t(last, torch.long))
    assert got[0].dtype == torch.float64 and got[2].shape == ()
    for g, r in zip(got[:2], ref[:2]):
        assert_messages_equal(g, r, got[2], ref[2])
    if case == STEEP:
        assert np.isneginf(np.asarray(ref[0])).any()


@pytest.mark.parametrize('case', range(len(CASES)))
def test_restart_scan_matches_jax(case, flush_denormal):
    jspec, frames, static_bank, be_bank_b = restart_inputs(case)
    cbi, seg, last = layout(jspec)
    ref = jscan.forward_backward_chains_restarts(
        jnp.asarray(frames), jnp.asarray(static_bank),
        jnp.asarray(be_bank_b), jspec.restart_plan, seg, jnp.asarray(last))
    plan = fb_scan.build_restart_plan(cbi, jspec.num_static_bank)
    got = fb_scan.forward_backward_chains_restarts(
        t(frames), t(static_bank), t(be_bank_b), plan, t(seg, torch.long),
        t(last, torch.long))
    assert got[2].shape == (R,)
    for g, r in zip(got[:2], ref[:2]):
        assert_messages_equal(g, r, got[2], ref[2])


@pytest.mark.parametrize('case', range(len(CASES)))
def test_restart_plan_matches_jax(case):
    _, jspec, _, _ = build(case)
    cbi = np.asarray(jspec.chain_bank_idx)
    got = fb_scan.build_restart_plan(cbi, jspec.num_static_bank)
    ref = jscan.build_restart_plan(cbi, jspec.num_static_bank)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key


def assert_significant_close(got, ref, atol, rtol):
    """Entries within 60 nats of their row maximum: below that the
    kernels' TINY floor and the scan's -inf part ways."""
    got, ref = got.numpy(), ref.numpy()
    significant = ref > (ref.max(axis=-1, keepdims=True) - 60.0)
    np.testing.assert_allclose(got[significant], ref[significant],
                               atol=atol, rtol=rtol)


TOLERANCES = {torch.float32: (2e-4, 1e-5), torch.float64: (1e-9, 0.0)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['float32', 'float64'])
@pytest.mark.parametrize('case', range(STEEP))
def test_scan_matches_plain_kernels(case, dtype):
    """Both scans against the plain versions of the kernels they stand in
    for, on the same log-space banks."""
    atol, rtol = TOLERANCES[dtype]
    jspec, frames, static_bank, be_bank_b = restart_inputs(case)
    cbi, seg, last = layout(jspec)
    args = (t(cbi, torch.int32), t(seg, torch.long), t(last, torch.long))
    plan = fb_scan.build_restart_plan(cbi, jspec.num_static_bank)

    scan = fb_scan.forward_backward_chains_restarts(
        t(frames, dtype), t(static_bank, dtype), t(be_bank_b, dtype), plan,
        *args[1:])
    plain = fb_grouped.forward_backward_chains_grouped(
        t(frames, dtype), t(static_bank, dtype),
        torch.exp(t(be_bank_b, dtype)), *args, scaled=False)
    for g, r in zip(scan[:2], plain[:2]):
        assert g.dtype == dtype
        assert_significant_close(g, r, atol, rtol)
    np.testing.assert_allclose(scan[2].numpy(), plain[2].numpy(),
                               rtol=max(rtol, 1e-12))

    bank = np.concatenate([static_bank, be_bank_b[0]])
    scan = fb_scan.forward_backward_chains(t(frames[0], dtype),
                                           t(bank, dtype), *args)
    plain = fb_chains.forward_backward_chains(
        t(frames[0], dtype), t(static_bank, dtype),
        torch.exp(t(be_bank_b[0], dtype)), *args, scaled=False)
    for g, r in zip(scan[:2], plain[:2]):
        assert_significant_close(g, r, atol, rtol)
    np.testing.assert_allclose(float(scan[2]), float(plain[2]),
                               rtol=max(rtol, 1e-12))


def port_spec(case, **kwargs):
    spec_kwargs, _, _, _ = build(case)
    return teng.ModelSpec(dtype=torch.float64, device='cpu',
                          **dict(spec_kwargs, **kwargs))


@pytest.mark.parametrize('dtype,device,route', [
    (torch.float32, 'cpu', True), (torch.float32, 'cuda', True),
    (torch.float64, 'cpu', False), (torch.float64, 'cuda', False)])
def test_default_route_by_dtype_and_device(dtype, device, route):
    """``use_kernels=None`` takes the kernel wrappers in float32 and the
    scan in float64, on the CPU and on the card alike; an explicit choice
    is kept."""
    assert teng.resolve_use_kernels(None, dtype) is route
    assert teng.resolve_use_kernels(True, dtype) is True
    assert teng.resolve_use_kernels(False, dtype) is False
    if device == 'cpu':
        spec_kwargs, _, _, _ = build(0)
        spec = teng.ModelSpec(dtype=dtype, device=device, **spec_kwargs)
        assert spec.use_kernels is route


@pytest.mark.parametrize('use_kernels,route', [
    (None, 'scan'), (True, 'kernels'), (False, 'scan')])
def test_use_kernels_picks_the_route(monkeypatch, use_kernels, route):
    """In float64 ``None`` means the scan, on the CPU as on the card;
    ``True`` the kernel wrappers (their plain versions on the CPU);
    ``False`` the scan, in the batched and the single-restart chain update
    alike."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls.append(module.__name__.split('.')[-1] + '.' + name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    for module, name in ((fb_grouped, 'forward_backward_chains_grouped'),
                         (fb_chains, 'forward_backward_chains'),
                         (fb_scan, 'forward_backward_chains_restarts'),
                         (fb_scan, 'forward_backward_chains')):
        spy(module, name)
    spec = port_spec(0, use_kernels=use_kernels)
    assert spec.use_kernels == (route == 'kernels')
    params = spec.init_params(np.array([0.2, 0.6]), 1e-7)
    state = spec.init_state()
    teng.variational_sweeps_restarts(spec, teng.one(params), teng.one(state),
                                     1)
    teng.variational_sweeps(spec, params, state, 1)
    want = (['fb_grouped.forward_backward_chains_grouped',
             'fb_chains.forward_backward_chains'] if route == 'kernels' else
            ['fb_scan.forward_backward_chains_restarts',
             'fb_scan.forward_backward_chains'])
    assert calls == want


def test_float64_reaching_a_kernel_wrapper_raises():
    """The kernels take float32 only: their input check refuses float64,
    so a float64 engine on the card cannot launch one by mistake."""
    S, Q, L, J = 4, 2, 3, 1
    f64 = torch.float64
    with pytest.raises(ValueError, match='float32'):
        fb_grouped.check_inputs(
            torch.zeros((2, Q, L, S), dtype=f64),
            torch.zeros((3, S, S), dtype=f64),
            torch.zeros((2, J, S, S), dtype=f64),
            torch.zeros((Q, L - 1), dtype=torch.int32))
