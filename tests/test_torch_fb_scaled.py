"""The scaled-linear chain forward-backward of the port
(``fb_grouped_scaled_*`` in ``remixt_tpu_torch/ops/fb_grouped.py``,
``fb_chains_scaled_*`` in ``ops/fb_chains.py``) on the CPU.

(a) the restart-batched plain scaled version in float32 against the JAX
    scaled Pallas kernel ``_fb_kernel_grouped_scaled``
    (``forward_backward_chains_pallas_grouped`` with ``SCALED_LINEAR``) in
    interpret mode, on ``test_torch_fb_grouped.py``'s cases;
(b) the single-restart plain scaled version against ``_fb_kernel_scaled``
    (``forward_backward_chains_pallas``, scaled) in interpret mode, on
    ``test_torch_fb_chains.py``'s cases and the S=128 case whose JAX plan
    widens the state padding for the log-scale column;
(c) both plain scaled versions in float64 against the JAX log-space scan;
(d) the wrappers take the plain scaled version for CPU tensors, with
    ``scaled=True`` or with the switch on;
(e) the scaled CUDA launchers check their inputs before touching a library.

Tolerances: (a) and (b) atol 2e-4 / rtol 1e-5 on entries within 60 nats of
the row maximum and log_norm rtol 1e-5, as ``test_fb_pallas.py`` holds the
scaled kernels; (c) atol 1e-9 on the same entries: the scaled recursion
floors only its output, not its carry, so it differs from the log-space one
only on states far below a lane's maximum. The CUDA kernels themselves are
held against the plain versions on the card by ``chip_smoke.py``.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.ops import fb_pallas, fb_scan
from remixt_tpu_torch.ops import fb_chains, fb_grouped

from test_fb_pallas import build_problem, exp_pad
from test_torch_fb_chains import CASES as CHAIN_CASES
from test_torch_fb_grouped import CASES as GROUPED_CASES
from test_torch_fb_grouped import R, assert_significant_close, restart_problem

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

# (seed, chain lengths, breakend fraction, S): the chain cases, and the
# case of test_fb_pallas.py where S is a lane multiple
SINGLE_CASES = dict({k: v + (7,) for k, v in CHAIN_CASES.items()},
                    s_is_lane_multiple=(7, [6, 3], 0.3, 128))


def as_t(a, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype)


def grouped_run(problem, dtype, **kwargs):
    J = problem['num_breakends']
    return fb_grouped.forward_backward_chains_grouped(
        as_t(problem['frame_b'], dtype), as_t(problem['static_bank'], dtype),
        torch.exp(as_t(problem['be_bank_b'][:, :J], dtype)),
        as_t(problem['chain_bank_idx'], torch.int32),
        as_t(problem['chain_seg_map'], torch.long),
        as_t(problem['chain_last'], torch.long), **kwargs)


def chains_run(problem, dtype, **kwargs):
    J = problem['num_breakends']
    return fb_chains.forward_backward_chains(
        as_t(problem['framelogprob'], dtype),
        as_t(problem['static_bank'], dtype),
        torch.exp(as_t(problem['be_bank'][:J], dtype)),
        as_t(problem['chain_bank_idx'], torch.int32),
        as_t(problem['chain_seg_map'], torch.long),
        as_t(problem['chain_last'], torch.long), **kwargs)


def assert_messages_close(got, ref, tol, log_norm_tol):
    """Messages at ``tol`` (atol, rtol) on significant entries, log_norm
    at ``log_norm_tol`` (a dict of ``assert_allclose`` tolerances)."""
    (a, b, ln), (a_ref, b_ref, ln_ref) = got, ref
    assert_significant_close(a.numpy(), np.asarray(a_ref), *tol)
    assert_significant_close(b.numpy(), np.asarray(b_ref), *tol)
    np.testing.assert_allclose(ln.numpy(), np.asarray(ln_ref),
                               **log_norm_tol)


@pytest.mark.parametrize('chains,be_frac', GROUPED_CASES)
def test_grouped_plain_f32_matches_pallas_scaled_interpret(
        monkeypatch, chains, be_frac):
    # the plan reads the switch: patch it first
    monkeypatch.setattr(fb_pallas, 'SCALED_LINEAR', True)
    problem = restart_problem(10, chains, be_frac)
    J = problem['num_breakends']
    S = problem['framelogprob'].shape[-1]
    Q, L = problem['chain_seg_map'].shape
    num_static = problem['static_bank'].shape[0]
    plan = fb_pallas.build_pallas_plan_restarts_grouped(
        np.asarray(problem['chain_bank_idx']), num_static, Q, L, S, R, J)
    be_exp_b = jnp.stack([exp_pad(problem['be_bank_b'][r], J, plan['Sp'], S)
                          for r in range(R)])
    ref = fb_pallas.forward_backward_chains_pallas_grouped(
        jnp.asarray(problem['frame_b'], dtype=jnp.float32),
        problem['static_bank'], be_exp_b,
        np.asarray(problem['chain_seg_map']), problem['chain_last'], plan,
        interpret=True)

    got = grouped_run(problem, torch.float32, scaled=True)
    assert got[0].dtype == torch.float32
    assert_messages_close(got, ref, (2e-4, 1e-5), dict(rtol=1e-5))


@pytest.mark.parametrize('case', sorted(SINGLE_CASES))
def test_chains_plain_f32_matches_pallas_scaled_interpret(monkeypatch, case):
    seed, chains, be_frac, S = SINGLE_CASES[case]
    monkeypatch.setattr(fb_pallas, 'SCALED_LINEAR', True)
    problem = build_problem(seed, chains, S=S, be_frac=be_frac)
    if S == 128:
        assert problem['plan']['Sp'] == 256
    ref = fb_pallas.forward_backward_chains_pallas(
        problem['framelogprob'], problem['static_bank'],
        problem['be_exp_pad'], problem['chain_seg_map'],
        problem['chain_last'], problem['plan'], interpret=True)

    got = chains_run(problem, torch.float32, scaled=True)
    assert got[0].dtype == torch.float32 and got[2].shape == ()
    assert_messages_close(got, ref, (2e-4, 1e-5), dict(rtol=1e-5))


@pytest.mark.parametrize('chains,be_frac', GROUPED_CASES)
def test_grouped_plain_f64_matches_log_space_scan(chains, be_frac):
    problem = restart_problem(11, chains, be_frac)
    num_static = problem['static_bank'].shape[0]
    scan_plan = fb_scan.build_restart_plan(
        np.asarray(problem['chain_bank_idx']), num_static)
    ref = fb_scan.forward_backward_chains_restarts(
        jnp.asarray(problem['frame_b']),
        jnp.asarray(np.asarray(problem['static_bank']), dtype=jnp.float64),
        jnp.asarray(problem['be_bank_b']), scan_plan,
        np.asarray(problem['chain_seg_map']), problem['chain_last'])

    got = grouped_run(problem, torch.float64, scaled=True)
    assert got[0].dtype == torch.float64
    assert_messages_close(got, ref, (1e-9, 0), dict(atol=1e-9))


@pytest.mark.parametrize('case', sorted(CHAIN_CASES))
def test_chains_plain_f64_matches_log_space_scan(case):
    seed, chains, be_frac = CHAIN_CASES[case]
    problem = build_problem(seed + 20, chains, be_frac=be_frac)
    as64 = lambda k: jnp.asarray(np.asarray(problem[k]), dtype=jnp.float64)
    ref = fb_scan.forward_backward_chains(
        as64('framelogprob'), as64('full_bank'), problem['chain_bank_idx'],
        problem['chain_seg_map'], problem['chain_last'])

    got = chains_run(problem, torch.float64, scaled=True)
    assert got[0].dtype == torch.float64
    assert_messages_close(got, ref, (1e-9, 0), dict(atol=1e-9))


def no_kernel(*args, **kwargs):
    raise AssertionError('CPU tensors must not reach a CUDA kernel')


def not_log_space(*args, **kwargs):
    raise AssertionError('the scaled recursion must not run the log-space '
                         'plain version')


@pytest.mark.parametrize('path', ['grouped', 'chains'])
@pytest.mark.parametrize('how', ['argument', 'switch'])
def test_wrapper_takes_plain_scaled_version_on_cpu(monkeypatch, path, how):
    for module, name in ((fb_grouped, 'fb_grouped_cuda'),
                         (fb_grouped, 'fb_grouped_scaled_cuda'),
                         (fb_chains, 'fb_chains_cuda'),
                         (fb_chains, 'fb_chains_scaled_cuda')):
        monkeypatch.setattr(module, name, no_kernel)
    monkeypatch.setattr(fb_grouped, 'fb_grouped_reference', not_log_space)
    if how == 'switch':
        monkeypatch.setattr(fb_grouped, 'SCALED_LINEAR', True)
    kwargs = {'scaled': True} if how == 'argument' else {}
    counters = ('LAUNCHES', 'LAUNCHES_SCALED')
    before = [getattr(m, c) for m in (fb_grouped, fb_chains) for c in counters]
    if path == 'grouped':
        problem = restart_problem(12, [14, 9, 5], 0.4)
        a, b, ln = grouped_run(problem, torch.float32, **kwargs)
        assert a.shape == b.shape == (R, problem['N'], 6)
        assert ln.shape == (R,)
    else:
        problem = build_problem(2, [16, 10], be_frac=0.8)
        a, b, ln = chains_run(problem, torch.float32, **kwargs)
        assert a.shape == b.shape == (problem['N'], 7)
        assert ln.shape == ()
    assert [getattr(m, c) for m in (fb_grouped, fb_chains)
            for c in counters] == before
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    assert torch.isfinite(ln).all()


def test_switch_is_read_from_the_environment():
    code = ('from remixt_tpu_torch.ops import fb_grouped\n'
            'assert fb_grouped.SCALED_LINEAR is True\n'
            'assert fb_grouped.LAUNCHES_SCALED == 0\n')
    subprocess.run([sys.executable, '-c', code], check=True,
                   env={'PYTHONPATH': ':'.join(sys.path),
                        'REMIXT_TPU_SCALED_LINEAR': '1'})


@pytest.mark.parametrize('path,bad', [
    (path, bad) for path in ('grouped', 'chains')
    for bad in ('dtype', 'shape', 'bank_steps')] + [('chains', 'cluster')])
def test_scaled_cuda_path_checks_its_inputs(path, bad):
    """The scaled kernel routes validate their inputs before touching the
    library (and so raise here, where no kernel can be built)."""
    lead = (2,) if path == 'grouped' else ()
    frames = torch.zeros(lead + (2, 4, 3))
    static_exp = torch.zeros((1, 3, 3))
    be_exp = torch.zeros(lead + (0, 3, 3))
    cbi = torch.zeros((2, 3), dtype=torch.int32)
    kwargs = {}
    if bad == 'dtype':
        frames = frames.double()
    elif bad == 'shape':
        be_exp = torch.zeros(lead + (1, 3, 4))
    elif bad == 'bank_steps':
        cbi = torch.zeros((2, 2), dtype=torch.int32)
    else:
        kwargs['cluster'] = 16
    launch = (fb_grouped.fb_grouped_scaled_cuda if path == 'grouped'
              else fb_chains.fb_chains_scaled_cuda)
    with pytest.raises(ValueError):
        launch(frames, static_exp, be_exp, cbi, **kwargs)
