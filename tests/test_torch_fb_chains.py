"""The single-restart chain forward-backward of the port
(``remixt_tpu_torch/ops/fb_chains.py``) on the CPU.

(a) its plain version in float32 against the JAX Pallas kernel
    ``_fb_kernel_wrapped`` (``forward_backward_chains_pallas``) run in
    interpret mode, at the tolerance ``test_fb_pallas.py`` holds that kernel
    to (atol 2e-4, rtol 1e-5 on entries within 60 nats of the row maximum,
    log_norm rtol 1e-5), on that file's problems;
(b) its plain version in float64 against the JAX chain scan, atol 1e-9;
(c) the wrapper takes the plain version for CPU tensors, the module imports
    without nvcc or a GPU, and the CUDA route checks its inputs;
(d) the launch plan matches the kernel source's layout and launcher (both
    kernels launch through one ``launch_chains``), fits three blocks a
    multiprocessor at cluster size 8 and refuses a cluster whose resident
    slice does not fit; the resident classes are chosen on the device with
    no host sync; the wrapper passes both launchers' C signatures.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import contextlib
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.ops import fb_pallas, fb_scan
from remixt_tpu_torch.ops import fb_chains, fb_grouped

from test_fb_pallas import build_problem
from test_torch_fb_grouped import c_expression

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

CSRC = Path(fb_chains.__file__).resolve().parent.parent / 'csrc'

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


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'bank_steps', 'cluster',
                                 'slice'])
def test_cuda_path_checks_its_inputs(bad):
    """The kernel route validates its inputs, the cluster size and the
    resident slice's fit before touching the library (and so raises here,
    where no kernel can be built)."""
    S = 355 if bad == 'slice' else 3
    frames = torch.zeros((2, 4, S))
    static_exp = torch.zeros((1, S, S))
    be_exp = torch.zeros((0, S, S))
    cbi = torch.zeros((2, 3), dtype=torch.int32)
    kwargs = {}
    if bad == 'dtype':
        frames = frames.double()
    elif bad == 'shape':
        be_exp = torch.zeros((1, 3, 4))
    elif bad == 'bank_steps':
        cbi = torch.zeros((2, 2), dtype=torch.int32)
    else:
        # 16 blocks exceed the portable cluster; 355 states' slices of 180
        # columns do not fit a block's shared memory on 2
        kwargs['cluster'] = 16 if bad == 'cluster' else 2
    with pytest.raises(ValueError):
        fb_chains.fb_chains_cuda(frames, static_exp, be_exp, cbi, **kwargs)


def launcher_body(source, name):
    """The body of function ``name`` (an ``extern "C"`` launcher or the
    ``launch_chains`` template both call) in the kernel source."""
    return re.search(r'\bint ' + name + r'\([^)]*\) \{(.*?)\n\}', source,
                     re.S).group(1)


def plan_matches_source(S, cluster):
    """Hold ``launch_plan(S, cluster)`` to the launcher's own formulas,
    evaluated from ``launch_chains`` in ``csrc/fb_chains.cu``: the block's
    slice, the floats before the partial sums (``chains_base_floats``) and
    the products' row groups, the same number for each block of the
    cluster; and check that the plan passes the launcher's checks of
    threads and partial sums. Returns the source."""
    source = (CSRC / 'fb_chains.cu').read_text()
    consts = {name: int(value) for name, value in
              re.findall(r'constexpr int (\w+) = (\d+);', source)}
    body = launcher_body(source, 'launch_chains')
    plan = fb_chains.launch_plan(S, cluster)
    env = dict(consts, S=S, cluster=cluster, min=min)
    per = eval(c_expression(body, r'const int per = ([^;]*);'), env)
    assert per == plan['per']
    base = eval(c_expression(source, r'size_t chains_base_floats\(int S, '
                             r'int per\) \{\s*return ([^;]*);'),
                dict(consts, S=S, per=per))
    assert base == fb_chains.chains_base_floats(S, per)
    threads = plan['threads']
    assert threads % 32 == 0 and per <= threads <= 1024
    red = plan['smem_bytes'] // 4 - base
    groups = plan['row_groups']
    assert red == groups * per
    assert groups % cluster == 0 and (per // 4) * groups <= threads
    env.update(per=per, threads=threads, red=red)
    assert eval(c_expression(body, r'const int Gc = ([^;]*);'),
                env) * cluster == groups >= cluster
    assert plan['smem_bytes'] <= fb_grouped.SMEM_LIMIT
    return source


@pytest.mark.parametrize('cluster', [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize('S', [7, 47, 355])
def test_launch_plan_matches_the_kernel_source(S, cluster):
    """The Python plan and the CUDA launcher lay shared memory out alike:
    the block's slice, the floats before the partial sums
    (``chains_base_floats``) and the products' row groups, the same number
    for each block of the cluster, the launcher's own formulas evaluated
    from ``csrc/fb_chains.cu``; and the plan passes the launcher's checks
    of threads and partial sums. The log-space launcher launches
    ``fb_chains_kernel`` through those formulas."""
    source = plan_matches_source(S, cluster)
    assert re.search(r'launch_chains\(fb_chains_kernel,',
                     launcher_body(source, 'fb_chains_launch'))


@pytest.mark.parametrize('cluster', [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize('S', [7, 47, 355])
def test_scaled_launch_plan_matches_the_kernel_source(S, cluster):
    """The same for the scaled kernel: its launcher launches
    ``fb_chains_scaled_kernel`` through ``launch_chains``'s formulas, and
    the kernel lays its shared memory out as ``chains_base_floats``
    counts it, its partial sums after them."""
    source = plan_matches_source(S, cluster)
    assert re.search(r'launch_chains\(fb_chains_scaled_kernel,',
                     launcher_body(source, 'fb_chains_scaled_launch'))
    kernel = re.search(r'fb_chains_scaled_kernel\((.*?)\n\}', source,
                       re.S).group(1)
    assert 'float* red = slice + chains_base_floats(S, per);' in kernel
    assert 'float* u = slice + (size_t)S * per;' in kernel


@pytest.mark.parametrize('cluster', [1, 2])
def test_launch_plan_refuses_a_slice_that_does_not_fit(cluster):
    """At 355 states a block of a cluster of 1 or 2 would hold 356 or 180
    columns of the resident class: more than a block's shared memory. The
    plan raises; it does not stream instead."""
    with pytest.raises(ValueError, match='does not fit'):
        fb_chains.launch_plan(355, cluster)


def test_launch_plan_fits_three_blocks_an_sm_at_cluster_8():
    """The main path's whole-genome problem at C=8: slices of 48 columns,
    68,160 bytes of resident class a block, and three blocks with the
    runtime's 1 KB each within a multiprocessor's 228 KB of shared memory
    and 65,536 registers at 64 a thread, so that all 46 clusters (368
    blocks) fit the card's 132 multiprocessors at once."""
    plan = fb_chains.launch_plan(355, 8)
    assert plan['per'] == 48 and 4 * 355 * plan['per'] == 68160
    assert plan['smem_bytes'] <= fb_grouped.SMEM_LIMIT
    assert 3 * (plan['smem_bytes'] + 1024) <= 228 * 1024
    assert 3 * plan['threads'] * 64 <= 65536
    assert 46 * 8 <= 3 * 132


# (schedule, steps counted, resident class) for num_static = 3 (0 the cut,
# 1 and 2 static classes, 3 and up breakends)
RESIDENT_CASES = {
    'one_class': ([1, 1, 0, 1, 4, 1], 6, 1),
    'tie_takes_the_lowest': ([2, 1, 0, 2, 1, 3], 6, 1),
    'two_static_classes': ([2, 2, 1, 0, 2, 5], 6, 2),
    'cuts_and_breakends_only': ([0, 3, 0, 4, 0, 0], 6, -1),
    'steps_past_the_chain_ignored': ([2, 0, 3, 1, 1, 1], 3, 2),
}


@pytest.mark.parametrize('case', sorted(RESIDENT_CASES))
def test_resident_classes(case):
    """The resident class of a chain is its most used non-cut static class
    over the counted steps, the lowest on a tie, -1 for none. The same
    call on the meta device, which holds no data, shows that it needs no
    host sync."""
    schedule, steps, expected = RESIDENT_CASES[case]
    # a second chain of one class beside it, so that chains do not mix
    cbi = torch.tensor([schedule, [1] * len(schedule)], dtype=torch.int32)
    got = fb_chains.resident_classes(cbi, 3, steps)
    assert got.dtype == torch.int32
    assert got.tolist() == [expected, 1]
    meta = fb_chains.resident_classes(cbi.to('meta'), 3, steps)
    assert meta.shape == (2,) and meta.dtype == torch.int32


def test_resident_classes_without_static_steps():
    cbi = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)
    assert fb_chains.resident_classes(cbi, 1, 2).tolist() == [-1, -1]
    assert fb_chains.resident_classes(cbi, 2, 0).tolist() == [-1, -1]


@pytest.mark.parametrize('scaled', [False, True])
def test_launch_passes_the_c_signature(monkeypatch, scaled):
    """The wrapper hands the launcher the arguments its ``extern "C"``
    signature in ``csrc/fb_chains.cu`` names, as many pointers and ints:
    the frames (the scaled kernel: ``fexp`` and ``fmax`` of
    ``shift_frames``), the padded statics and the resident classes, and
    the cluster, threads and shared memory of ``launch_plan`` last before
    the stream. The library and the stream are stubbed: no kernel runs
    here."""
    name = 'fb_chains_scaled_launch' if scaled else 'fb_chains_launch'
    source = (CSRC / 'fb_chains.cu').read_text()
    params = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)',
                       source).group(1).split(',')
    names = [p.split()[-1].lstrip('*') for p in params]
    kinds = ['int' if re.match(r'\s*int \w+$', p) else 'pointer'
             for p in params]
    assert kinds[-1] == 'pointer' and names[-1] == 'stream'
    calls, made = [], {}

    def launcher(unit, entry, num_ptrs, num_ints, defines=()):
        assert (unit, entry, defines) == ('fb_chains', name, ())
        assert kinds == (['pointer'] * num_ptrs + ['int'] * num_ints
                         + ['pointer'])
        return (lambda *args: calls.append(args) or 0), None

    def recorded(key, fn):
        def wrapper(*args):
            made[key] = fn(*args)
            return made[key]
        return wrapper

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fb_grouped, 'load_launcher', launcher)
    monkeypatch.setattr(fb_grouped, 'pad_statics',
                        recorded('statics', fb_grouped.pad_statics))
    monkeypatch.setattr(fb_chains, 'resident_classes',
                        recorded('resident', fb_chains.resident_classes))
    monkeypatch.setattr(fb_grouped, 'shift_frames',
                        recorded('shift', fb_grouped.shift_frames))
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device: Stream)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda device: contextlib.nullcontext())
    Q, L, S = 2, 4, 6
    frames = torch.zeros((Q, L, S))
    static_exp = torch.zeros((3, S, S))
    cbi = torch.tensor([[2, 1, 2, 0], [1, 3, 0, 0]], dtype=torch.int32)
    launch = (fb_chains.fb_chains_scaled_cuda if scaled
              else fb_chains.fb_chains_cuda)
    before = (fb_chains.LAUNCHES, fb_chains.LAUNCHES_SCALED)
    launch(frames, static_exp, torch.zeros((1, S, S)), cbi, cluster=3)
    (args,) = calls
    assert len(args) == len(params)
    by_name = dict(zip(names, args))
    assert (by_name['Q'], by_name['L'], by_name['S'], by_name['Lm1'],
            by_name['num_static'], by_name['cluster']) == (Q, L, S, 4, 3, 3)
    assert by_name['cbi'] == cbi.data_ptr()
    plan = fb_chains.launch_plan(S, 3)
    assert args[-4:-1] == (3, plan['threads'], plan['smem_bytes'])
    assert by_name['statics'] == made['statics'].data_ptr()
    assert made['statics'].shape == (2, 3, S, 8)
    assert by_name['resident'] == made['resident'].data_ptr()
    assert made['resident'].tolist() == [2, 1]
    if scaled:
        fexp, fmax = made['shift']
        assert (by_name['fexp'], by_name['fmax']) == (fexp.data_ptr(),
                                                      fmax.data_ptr())
        assert fexp.shape == (Q, L, S) and fmax.shape == (Q, L)
        assert fb_chains.LAUNCHES_SCALED == before[1] + 1
    else:
        assert by_name['frames'] == frames.data_ptr()
        assert 'shift' not in made
        assert fb_chains.LAUNCHES == before[0] + 1
