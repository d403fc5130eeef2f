"""The restart-batched chain forward-backward of the port
(``remixt_tpu_torch/ops/fb_grouped.py``) on the CPU.

(a) its plain version in float32 against the JAX grouped Pallas kernel
    (``forward_backward_chains_pallas_grouped``) run in interpret mode, at
    the tolerance the JAX package holds that kernel to;
(b) its plain version in float64 against the JAX restart-batched scan;
(c) the wrapper takes the plain version for CPU tensors, and the module
    imports without nvcc or a GPU;
(d) the CUDA route checks its inputs before it loads a library, and the
    launch plan fits the card and matches the kernel source's layout.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.ops import fb_pallas, fb_scan
from remixt_tpu_torch.ops import fb_grouped

from test_fb_pallas import build_problem, exp_pad

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

R = 3
CSRC = Path(fb_grouped.__file__).resolve().parent.parent / 'csrc'


def restart_problem(seed, chain_lengths, be_frac):
    problem = build_problem(seed, chain_lengths, S=6, be_frac=be_frac)
    rng = np.random.RandomState(seed + 100)
    S = problem['framelogprob'].shape[-1]
    J = problem['num_breakends']
    problem['frame_b'] = -5.0 * rng.rand(R, problem['N'], S)
    problem['be_bank_b'] = -3.0 * rng.rand(R, max(J, 1), S, S)
    return problem


def torch_run(problem, dtype):
    J = problem['num_breakends']
    as_t = lambda a, dt=dtype: torch.as_tensor(np.array(a), dtype=dt)
    return fb_grouped.forward_backward_chains_grouped(
        as_t(problem['frame_b']), as_t(problem['static_bank']),
        torch.exp(as_t(problem['be_bank_b'][:, :J])),
        as_t(problem['chain_bank_idx'], torch.int32),
        as_t(problem['chain_seg_map'], torch.long),
        as_t(problem['chain_last'], torch.long))


def assert_significant_close(got, ref, atol, rtol):
    """Compare where messages carry posterior-relevant mass: unreachable
    states clip to different large negative floors."""
    significant = ref > (ref.max(axis=-1, keepdims=True) - 60.0)
    np.testing.assert_allclose(got[significant], ref[significant],
                               atol=atol, rtol=rtol)


CASES = [([14, 9, 5], 0.4), ([14, 9, 5], 0.0), ([8, 8, 8, 8], 0.9),
         ([9, 4, 13, 1], 0.3)]


@pytest.mark.parametrize('chains,be_frac', CASES)
def test_plain_f32_matches_pallas_grouped_interpret(chains, be_frac):
    problem = restart_problem(10, chains, be_frac)
    J = problem['num_breakends']
    assert (J == 0) == (be_frac == 0.0)
    S = problem['framelogprob'].shape[-1]
    Q, L = problem['chain_seg_map'].shape
    num_static = problem['static_bank'].shape[0]
    plan = fb_pallas.build_pallas_plan_restarts_grouped(
        np.asarray(problem['chain_bank_idx']), num_static, Q, L, S, R, J)
    be_exp_b = jnp.stack([exp_pad(problem['be_bank_b'][r], J, plan['Sp'], S)
                          for r in range(R)])
    a_ref, b_ref, ln_ref = fb_pallas.forward_backward_chains_pallas_grouped(
        jnp.asarray(problem['frame_b'], dtype=jnp.float32),
        problem['static_bank'], be_exp_b,
        np.asarray(problem['chain_seg_map']), problem['chain_last'], plan,
        interpret=True)

    a, b, ln = torch_run(problem, torch.float32)
    assert a.dtype == torch.float32
    assert_significant_close(a.numpy(), np.asarray(a_ref), 2e-4, 1e-5)
    assert_significant_close(b.numpy(), np.asarray(b_ref), 2e-4, 1e-5)
    np.testing.assert_allclose(ln.numpy(), np.asarray(ln_ref), rtol=1e-5)


@pytest.mark.parametrize('chains,be_frac', CASES)
def test_plain_f64_matches_restart_scan(chains, be_frac):
    problem = restart_problem(11, chains, be_frac)
    num_static = problem['static_bank'].shape[0]
    scan_plan = fb_scan.build_restart_plan(
        np.asarray(problem['chain_bank_idx']), num_static)
    a_ref, b_ref, ln_ref = fb_scan.forward_backward_chains_restarts(
        jnp.asarray(problem['frame_b']),
        jnp.asarray(np.asarray(problem['static_bank']), dtype=jnp.float64),
        jnp.asarray(problem['be_bank_b']), scan_plan,
        np.asarray(problem['chain_seg_map']), problem['chain_last'])

    a, b, ln = torch_run(problem, torch.float64)
    assert a.dtype == torch.float64
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=1e-9)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), atol=1e-9)
    np.testing.assert_allclose(ln.numpy(), np.asarray(ln_ref), atol=1e-9)


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    problem = restart_problem(12, [14, 9, 5], 0.4)

    def no_kernel(*args, **kwargs):
        raise AssertionError('CPU tensors must not reach the CUDA kernel')

    monkeypatch.setattr(fb_grouped, 'fb_grouped_cuda', no_kernel)
    before = fb_grouped.LAUNCHES
    a, b, ln = torch_run(problem, torch.float32)
    assert fb_grouped.LAUNCHES == before
    assert a.shape == b.shape == (R, problem['N'], 6)
    assert ln.shape == (R,)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()


def test_module_imports_without_nvcc_or_gpu():
    code = ('import os, shutil, torch\n'
            'os.environ["PATH"] = ""\n'
            'from remixt_tpu_torch.ops import fb_grouped, _build\n'
            'assert shutil.which("nvcc") is None\n'
            'assert fb_grouped.LAUNCHES == 0\n')
    subprocess.run([sys.executable, '-c', code], check=True,
                   env={'PYTHONPATH': ':'.join(sys.path)})


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'bank_steps',
                                 'cluster', 'no_cluster'])
def test_cuda_path_checks_its_inputs(bad):
    """The kernel route validates its inputs and the cluster size before
    touching the library (and so raises here, where no kernel can be
    built)."""
    frames = torch.zeros((2, 2, 4, 3))
    static_exp = torch.zeros((1, 3, 3))
    be_exp = torch.zeros((2, 0, 3, 3))
    cbi = torch.zeros((2, 3), dtype=torch.int32)
    kwargs = {}
    if bad == 'dtype':
        frames = frames.double()
    elif bad == 'shape':
        be_exp = torch.zeros((2, 1, 3, 4))
    elif bad == 'bank_steps':
        cbi = torch.zeros((2, 2), dtype=torch.int32)
    else:
        kwargs['cluster'] = 16 if bad == 'cluster' else 0
    with pytest.raises(ValueError):
        fb_grouped.fb_grouped_cuda(frames, static_exp, be_exp, cbi, **kwargs)


@pytest.mark.parametrize('cluster', [1, 4, 8])
@pytest.mark.parametrize('S', [6, 355, 1000])
def test_launch_plan_fits_the_card(S, cluster):
    """Restart tiles, whole warps of at most 1024 threads that cover a
    block's column slice, slices of whole quads that share the S states
    out over the cluster's blocks, and shared memory within a block's 227
    KB, for every wave size."""
    for R in (1, 4, 8, 9):
        plan = fb_grouped.launch_plan(R, S, cluster)
        assert plan['tiles'] == -(-R // 8)
        threads, per = plan['threads'], plan['per']
        assert threads % 32 == 0 and threads <= 1024
        # the least multiple of 4 that shares the S states out
        assert per % 4 == 0 and per - 4 < S / cluster <= per
        assert threads >= -(-per // 32) * 32
        assert 1 <= plan['static_groups'] <= threads // (per // 4)
        assert plan['smem_bytes'] <= 227 * 1024
    if S == 355 and cluster == 4:
        # the main path: two blocks a multiprocessor, so that all 46
        # clusters of the whole-genome problem are resident at once
        assert 2 * plan['smem_bytes'] <= 228 * 1024
        assert 2 * threads * 64 <= 65536


def c_expression(source, pattern):
    """The integer C expression that ``pattern`` captures in the kernel
    source, as Python: casts dropped, ``/`` as floor division."""
    expr = re.search(pattern, source).group(1)
    expr = re.sub(r'\((?:int|size_t)\)', '', expr).replace('/', '//')
    return '({})'.format(expr)


@pytest.mark.parametrize('cluster', [1, 4, 8])
@pytest.mark.parametrize('S', [6, 355, 1000])
def test_launch_plan_matches_the_kernel_source(S, cluster):
    """The Python plan and the CUDA launcher lay shared memory out alike:
    the restart tile, the block's slice, the floats before the partial
    sums and the static product's row groups, the launcher's own formulas
    evaluated from ``csrc/fb_grouped.cu``."""
    source = (CSRC / 'fb_grouped.cu').read_text()
    consts = {name: int(value) for name, value in
              re.findall(r'constexpr int (\w+) = (\d+);', source)}
    assert consts['RT'] == fb_grouped.RESTART_TILE
    plan = fb_grouped.launch_plan(8, S, cluster)
    env = dict(consts, S=S, cluster=cluster, min=min)
    assert eval(c_expression(source, r'const int per = ([^;]*);'),
                env) == plan['per']
    env['per'] = plan['per']
    base = eval(c_expression(
        source, r'size_t tile_base_floats\(int S, int per\) \{\s*return '
        r'([^;]*);'), env)
    assert base == fb_grouped.tile_base_floats(S, plan['per'])
    red = plan['smem_bytes'] // 4 - base
    assert red >= consts['RT'] * max(plan['threads'], plan['per'])
    env.update(threads=plan['threads'], red=red)
    assert eval(c_expression(source, r'const int SG = ([^;]*);'),
                env) == plan['static_groups']


def test_padded_statics_hold_the_matrices_and_their_transposes():
    rng = np.random.RandomState(3)
    static_exp = torch.as_tensor(rng.rand(3, 7, 7))
    statics = fb_grouped.pad_statics(static_exp)
    assert statics.shape == (2, 3, 7, 8) and statics.is_contiguous()
    assert torch.equal(statics[0, :, :, :7], static_exp)
    assert torch.equal(statics[1, :, :, :7], static_exp.transpose(1, 2))
    assert not statics[..., 7:].any()
