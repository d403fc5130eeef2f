"""The single-restart chain forward-backward of the port
(``remixt_tpu_torch/ops/fb_chains.py``) on the CPU.

(a) its plain version in float32 against the JAX Pallas kernel
    ``_fb_kernel_wrapped`` (``forward_backward_chains_pallas``) run in
    interpret mode, at the tolerance ``test_fb_pallas.py`` holds that kernel
    to (atol 2e-4, rtol 1e-5 on entries within 60 nats of the row maximum,
    log_norm rtol 1e-5), on that file's problems;
(b) its plain version in float64 against the JAX chain scan, atol 1e-9;
(c) the wrapper takes the plain version for CPU tensors, the module imports
    without nvcc or a GPU, and the CUDA route checks its inputs.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.ops import fb_pallas, fb_scan
from remixt_tpu_torch.ops import fb_chains

from test_fb_pallas import build_problem

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

# (seed, chain lengths, breakend fraction): the cases of test_fb_pallas.py
CASES = {
    'single_chain_no_breakends': (0, [12], 0.0),
    'multi_chain_uneven': (1, [9, 4, 13, 1], 0.25),
    'breakend_heavy': (2, [16, 10], 0.8),
    'same_step_breakends_across_lanes': (3, [8, 8, 8, 8], 0.9),
    'no_breakends': (4, [5, 3, 7, 2, 6, 4, 8, 1, 5, 2], 0.0),
}


def torch_run(problem, dtype):
    J = problem['num_breakends']
    as_t = lambda a, dt=dtype: torch.as_tensor(np.array(a), dtype=dt)
    return fb_chains.forward_backward_chains(
        as_t(problem['framelogprob']), as_t(problem['static_bank']),
        torch.exp(as_t(problem['be_bank'][:J])),
        as_t(problem['chain_bank_idx'], torch.int32),
        as_t(problem['chain_seg_map'], torch.long),
        as_t(problem['chain_last'], torch.long))


def assert_significant_close(got, ref, atol, rtol):
    """Compare where messages carry posterior-relevant mass: unreachable
    states clip to different large negative floors."""
    significant = ref > (ref.max(axis=-1, keepdims=True) - 60.0)
    np.testing.assert_allclose(got[significant], ref[significant],
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_f32_matches_pallas_interpret(case):
    seed, chains, be_frac = CASES[case]
    problem = build_problem(seed, chains, be_frac=be_frac)
    assert (problem['num_breakends'] == 0) == (be_frac == 0.0)
    a_ref, b_ref, ln_ref = fb_pallas.forward_backward_chains_pallas(
        problem['framelogprob'], problem['static_bank'],
        problem['be_exp_pad'], problem['chain_seg_map'],
        problem['chain_last'], problem['plan'], interpret=True)

    a, b, ln = torch_run(problem, torch.float32)
    assert a.dtype == torch.float32 and ln.shape == ()
    assert_significant_close(a.numpy(), np.asarray(a_ref), 2e-4, 1e-5)
    assert_significant_close(b.numpy(), np.asarray(b_ref), 2e-4, 1e-5)
    np.testing.assert_allclose(float(ln), float(ln_ref), rtol=1e-5)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_f64_matches_scan(case):
    seed, chains, be_frac = CASES[case]
    problem = build_problem(seed + 20, chains, be_frac=be_frac)
    as64 = lambda k: jnp.asarray(np.asarray(problem[k]), dtype=jnp.float64)
    a_ref, b_ref, ln_ref = fb_scan.forward_backward_chains(
        as64('framelogprob'), as64('full_bank'), problem['chain_bank_idx'],
        problem['chain_seg_map'], problem['chain_last'])

    a, b, ln = torch_run(problem, torch.float64)
    assert a.dtype == torch.float64
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=1e-9)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), atol=1e-9)
    np.testing.assert_allclose(float(ln), float(ln_ref), atol=1e-9)


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    problem = build_problem(2, [16, 10], be_frac=0.8)

    def no_kernel(*args, **kwargs):
        raise AssertionError('CPU tensors must not reach the CUDA kernel')

    monkeypatch.setattr(fb_chains, 'fb_chains_cuda', no_kernel)
    before = fb_chains.LAUNCHES
    a, b, ln = torch_run(problem, torch.float32)
    assert fb_chains.LAUNCHES == before
    assert a.shape == b.shape == (problem['N'], 7)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    assert torch.isfinite(ln)


def test_module_imports_without_nvcc_or_gpu():
    code = ('import os, shutil, torch\n'
            'os.environ["PATH"] = ""\n'
            'from remixt_tpu_torch.ops import fb_chains, _build\n'
            'assert shutil.which("nvcc") is None\n'
            'assert fb_chains.LAUNCHES == 0\n')
    subprocess.run([sys.executable, '-c', code], check=True,
                   env={'PYTHONPATH': ':'.join(sys.path)})


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'bank_steps', 'cluster'])
def test_cuda_path_checks_its_inputs(bad):
    """The kernel route validates its inputs before touching the library
    (and so raises here, where no kernel can be built)."""
    frames = torch.zeros((2, 4, 3))
    static_exp = torch.zeros((1, 3, 3))
    be_exp = torch.zeros((0, 3, 3))
    cbi = torch.zeros((2, 3), dtype=torch.int32)
    kwargs = {}
    if bad == 'dtype':
        frames = frames.double()
    elif bad == 'shape':
        be_exp = torch.zeros((1, 3, 4))
    elif bad == 'bank_steps':
        cbi = torch.zeros((2, 2), dtype=torch.int32)
    else:
        kwargs['cluster'] = 16
    with pytest.raises(ValueError):
        fb_chains.fb_chains_cuda(frames, static_exp, be_exp, cbi, **kwargs)
