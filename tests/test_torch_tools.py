"""The port's measurement tools on the CPU, and the engine's named ranges
they read.

* ``tools/problem.build_problem`` builds the JAX package's
  ``bench.build_problem`` (data and shapes exactly).
* The ranges: a fit under ``torch.profiler`` equals the same fit without
  it bit for bit, batched and one restart, and its profile holds every
  sweep and EM range.
* ``sweep_budget`` in both modes through ``main([..., '--device',
  'cpu'])``: the JAX tool's keys (listed below with their lines in
  ``tools/sweep_budget.py``) with the port's renames, and the components
  plus the unattributed time equal to the block's time.
* ``summarize_trace``: exact self times on a synthetic trace of known
  nesting, device events by summed duration, and the engine's ranges
  ranked in ``profile_engine``'s CPU trace.

No tool writes a file unless ``--out`` names one, and the JAX package's
artifacts keep their bytes (``run_tool``).
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import bench
from remixt_tpu_torch.models import em as em_mod
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.models.fit import BreakpointModel
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched
from remixt_tpu_torch.simulations import simple as sim
from remixt_tpu_torch.tools import (problem, profile_engine, summarize_trace,
                                    sweep_budget)

# the tensors are small: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ARTIFACTS = ('SWEEP_BUDGET.json', 'FIT_BUDGET.json',
                 'FIT_BUDGET_TRACE.json', 'RESTART_SCALING.json',
                 'BENCH_DETAIL.json')
# the tools' problem at the tests' size: N=60, S=355, one chain
SMALL = ['--n', '60', '--events', '4', '--device', 'cpu']

COMPONENTS = ('emissions', 'p_allele_swap', 'be_bank', 'p_cn_chain',
              'p_breakpoint', 'p_outlier_total', 'p_outlier_allele')
# tools/sweep_budget.py:131-151, trace_attribution's keys
JAX_SWEEP_TRACE_KEYS = (
    ['N', 'S', 'K', 'J', 'Q', 'L', 'restarts', 'use_pallas', 'mode',
     'num_sweeps_per_block', 'block_wall_ms', 'block_device_ms',
     'per_sweep_device_ms']
    + [c + s for c in COMPONENTS for s in ('_ms_per_block', '_ms_per_sweep')]
    + ['unattributed_ms_per_block', 'sum_components_ms_per_block'])
# tools/sweep_budget.py:185-257, the standalone pieces and their keys
JAX_SWEEP_STANDALONE_KEYS = (
    ['N', 'S', 'K', 'J', 'Q', 'L', 'restarts', 'use_pallas', 'mode']
    + [p + '_ms' for p in ('emissions', 'p_allele_swap', 'p_cn_chain',
                           'be_bank', 'p_breakpoint', 'p_outlier_total',
                           'p_outlier_allele', 'full_sweep')]
    + ['sum_updates_ms'])


def port_keys(jax_keys):
    """The JAX keys as the port writes them on the CPU: ``use_pallas`` is
    ``use_kernels``, a key's ``device`` time is ``cpu`` time, and a
    ``device`` record is added."""
    renamed = [k.replace('use_pallas', 'use_kernels').replace('device',
                                                              'cpu')
               for k in jax_keys]
    return set(renamed) | {'device'}


def artifact_digests():
    out = {}
    for name in JAX_ARTIFACTS:
        with open(os.path.join(REPO, name), 'rb') as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def run_tool(module, argv, tmp_path, monkeypatch, made=()):
    """``module.main(argv)`` from an empty working directory: it must
    leave there only the files ``made``, and the JAX artifacts' bytes as
    they were. Returns what main returned."""
    work = tmp_path / 'cwd'
    work.mkdir()
    monkeypatch.chdir(work)
    before = artifact_digests()
    out = module.main(argv)
    assert sorted(os.listdir(work)) == sorted(made)
    assert artifact_digests() == before
    return out


@pytest.mark.parametrize('N, events', [(260, 10), (512, 26)])
def test_build_problem_is_the_bench_problem(N, events):
    spec, params, state, data = problem.build_problem(N, events,
                                                      device='cpu')
    jspec, jparams, _, jdata = bench.build_problem(N, events)
    for key in ('x', 'l', 'h'):
        np.testing.assert_array_equal(data[key], jdata[key], err_msg=key)
    assert data['adjacencies'] == jdata['adjacencies']
    assert data['breakpoints'] == jdata['breakpoints']
    for key in ('N', 'S', 'K', 'J', 'Q', 'L'):
        assert getattr(spec, key) == getattr(jspec, key), key
    assert spec.dtype == torch.float32 and spec.device.type == 'cpu'
    np.testing.assert_array_equal(params.h.numpy(),
                                  np.asarray(jparams.h))
    assert state.posterior_marginals.shape == (spec.N, spec.S)


def small_model():
    data = sim.simulate_experiment(N=40, M=3, h=(0.08, 0.05, 0.025),
                                   cn_max=4, num_events=4, seed=3,
                                   num_chains=2)
    model = BreakpointModel(
        data['x'], data['l'], data['adjacencies'], data['breakpoints'],
        max_copy_number=4, max_depth=1e9, min_segment_length=1.0,
        min_proportion_genotyped=0.0, divergence_weight=1e-7,
        random_seed=1234, device='cpu')
    model.num_em_iter = 2
    model.num_update_iter = 2
    return model, data


def single_fit():
    model, data = small_model()
    model.fit(data['h'])
    return model.params, model.state, model.prev_elbo


def batched_fit():
    model, data = small_model()
    rng = np.random.RandomState(1)
    h_inits = [data['h'] * (1.0 + 0.1 * rng.rand(3)) for _ in range(3)]
    results = fit_restarts_batched(model, h_inits, [1e-7, 1e-6, 1e-7],
                                   chunk_size=2)
    return ([r['params'] for r in results], [r['state'] for r in results],
            [r['elbo'] for r in results])


def assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize('fit', [single_fit, batched_fit],
                         ids=['single', 'batched'])
def test_profiled_fit_equals_the_fit(fit):
    plain = fit()
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = fit()
    assert_trees_equal(profiled, plain)


def test_a_sweep_block_and_an_em_iteration_hold_every_range():
    model, data = small_model()
    model._ensure_spec(3)
    spec = model.spec
    names = tuple(model.likelihood_params)
    params_b = eng.stack([spec.init_params(
        data['h'], 1e-7, total_mask=model._total_likelihood_mask.astype(float),
        allele_mask=model._allele_likelihood_mask.astype(float))])
    state_b = eng.stack([spec.init_state()])
    rngs = [np.random.RandomState(0)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state_b = eng.variational_sweeps_restarts(spec, params_b, state_b, 1)
        params_b, _ = em_mod.update_h_fused_batched(spec, params_b, state_b,
                                                    rngs)
        weights = em_mod.param_sample_weights_all_batched(spec, state_b,
                                                          names)
        em_mod.update_params_fused_batched(
            spec, params_b, state_b, names, model.likelihood_param_bounds,
            rngs, weights_lists=weights)
    ranges = eng.SWEEP_RANGES + em_mod.EM_RANGES
    assert len(set(ranges)) == 13
    assert set(ranges) <= {e.name for e in prof.events()}


@pytest.mark.parametrize('restarts', [0, 2])
def test_sweep_ranges_are_disjoint_siblings(restarts):
    """No sweep range nests in another, and each sweep enters each range
    but the emissions' once."""
    spec, params, state, _ = problem.build_problem(60, 4, device='cpu')
    if restarts:
        params, state = problem.restart_wave(params, state, restarts)
        block = eng.variational_sweeps_restarts
    else:
        block = eng.variational_sweeps
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        block(spec, params, state, 2)
    ranges = [e for e in prof.events() if e.name in eng.SWEEP_RANGES]
    counts = {r: sum(e.name == r for e in ranges) for r in eng.SWEEP_RANGES}
    assert counts == {r: 1 if r == 'sweep_emissions' else 2
                      for r in eng.SWEEP_RANGES}
    for e in ranges:
        parent = e.cpu_parent
        while parent is not None:
            assert parent.name not in eng.SWEEP_RANGES
            parent = parent.cpu_parent


@pytest.mark.parametrize('restarts', [0, 2])
def test_sweep_budget_trace(tmp_path, monkeypatch, restarts):
    out_file = str(tmp_path / 'budget.json')
    out = run_tool(sweep_budget, SMALL + [
        '--restarts', str(restarts), '--iters', '1', '--sweeps', '2',
        '--out', out_file], tmp_path, monkeypatch)
    with open(out_file) as f:
        assert json.load(f) == out
    assert set(out) == port_keys(JAX_SWEEP_TRACE_KEYS)
    assert out['device']['platform'] == 'cpu'
    assert out['mode'] == 'trace' and out['restarts'] == restarts
    assert out['use_kernels'] is True
    assert (out['S'], out['Q']) == (355, 1)
    parts = sum(out[c + '_ms_per_block'] for c in COMPONENTS)
    assert out['sum_components_ms_per_block'] == pytest.approx(parts,
                                                               abs=5e-3)
    assert parts + out['unattributed_ms_per_block'] == pytest.approx(
        out['block_cpu_ms'], abs=1e-2)
    assert out['unattributed_ms_per_block'] >= 0.0
    assert out['p_cn_chain_ms_per_block'] > 0.0
    assert out['per_sweep_cpu_ms'] == pytest.approx(
        out['block_cpu_ms'] / 2, abs=1e-3)


@pytest.mark.parametrize('restarts', [0, 2])
def test_sweep_budget_standalone(tmp_path, monkeypatch, restarts):
    out = run_tool(sweep_budget, SMALL + [
        '--standalone', '--restarts', str(restarts), '--iters', '1'],
        tmp_path, monkeypatch)
    assert set(out) == port_keys(JAX_SWEEP_STANDALONE_KEYS)
    assert out['mode'] == 'standalone_upper_bounds'
    updates = sum(out[p + '_ms'] for p in COMPONENTS if p != 'emissions')
    assert out['sum_updates_ms'] == pytest.approx(updates, abs=5e-3)
    assert all(out[p + '_ms'] > 0 for p in COMPONENTS)


def test_attribute_splits_a_cpu_profile():
    """Two ranges, one entered twice, and time outside every range: the
    buckets are the ranges' inclusive times, the rest is unattributed."""
    from torch.profiler import record_function

    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('a'):
            for _ in range(3):
                x = x @ x / 64
        x = x + 1
        with record_function('b'):
            x = x.exp().log()
        with record_function('a'):
            x = x * 2
    buckets, unattributed, total = sweep_budget.attribute(
        prof, ('a', 'b'), torch.device('cpu'))
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    assert total == pytest.approx(sum(e.self_cpu_time_total
                                      for e in events))
    for name in ('a', 'b'):
        assert buckets[name] == pytest.approx(sum(
            e.cpu_time_total for e in events if e.name == name))
    outside = sum(e.cpu_time_total for e in events
                  if e.cpu_parent is None and e.name not in ('a', 'b'))
    assert unattributed == pytest.approx(outside)
    assert outside > 0


class DeviceProfile:
    """A profile's device timeline, as ``torch.profiler`` gives it on the
    card: (name, start us, end us, is a range's annotation)."""

    def __init__(self, spans):
        from torch.autograd.profiler_util import FunctionEvent
        self._events = [
            FunctionEvent(id=i, name=name, thread=0, start_us=start,
                          end_us=end, device_type=DeviceType.CUDA,
                          is_user_annotation=annotation)
            for i, (name, start, end, annotation) in enumerate(spans)]

    def events(self):
        return self._events


def test_attribute_splits_a_device_timeline():
    """Each kernel, copy or set goes to the range whose annotation holds
    it; the annotations are no device time; what no annotation holds is
    unattributed."""
    prof = DeviceProfile([
        ('a', 10.0, 30.0, True),
        ('k1', 10.0, 14.0, False),          # an operator's kernel
        ('fb_grouped_kernel', 15.0, 25.0, False),   # launched by ctypes
        ('k2', 26.0, 30.0, False),
        ('Memcpy HtoD', 31.0, 32.5, False),  # between the ranges
        ('b', 33.0, 40.0, True),
        ('k3', 33.0, 40.0, False),
        ('a', 41.0, 45.0, True),
        ('k4', 41.5, 44.0, False),
    ])
    buckets, unattributed, total = sweep_budget.attribute(
        prof, ('a', 'b', 'c'), torch.device('cuda'))
    assert buckets == {'a': 4.0 + 10.0 + 4.0 + 2.5, 'b': 7.0, 'c': 0.0}
    assert (unattributed, total) == (1.5, 29.0)


def test_attribute_counts_nested_ranges_twice():
    """A device event under two ranges counts in both, so the parts no
    longer sum to the total: the fault phase 5b's gate catches."""
    prof = DeviceProfile([('a', 0.0, 10.0, True), ('b', 2.0, 8.0, True),
                          ('k', 3.0, 5.0, False), ('m', 9.0, 9.5, False)])
    buckets, unattributed, total = sweep_budget.attribute(
        prof, ('a', 'b'), torch.device('cuda'))
    assert buckets == {'a': 2.5, 'b': 2.0} and unattributed == 0.0
    assert sum(buckets.values()) + unattributed > total == 2.5


def test_attribute_refuses_a_profile_without_device_time():
    prof = DeviceProfile([('a', 0.0, 10.0, True)])
    with pytest.raises(RuntimeError, match='no device time'):
        sweep_budget.attribute(prof, ('a',), torch.device('cuda'))


def chrome_trace(events):
    return {'traceEvents': [dict(ph='X', pid=1, **e) for e in events]}


def test_summarize_trace_self_times():
    """A parent with two children, one of which has a child of its own,
    on one thread; another thread's op; a range; events of other kinds
    left out. Self times to the nanosecond."""
    trace = chrome_trace([
        dict(cat='user_annotation', name='sweep_p_cn_chain', tid=1,
             ts=100.0, dur=50.0),
        dict(cat='cpu_op', name='aten::mm', tid=1, ts=105.5, dur=20.25),
        dict(cat='cpu_op', name='aten::add', tid=1, ts=110.0, dur=5.125),
        dict(cat='cpu_op', name='aten::mm', tid=1, ts=130.0, dur=19.999),
        dict(cat='cpu_op', name='aten::add', tid=2, ts=101.0, dur=7.0),
        dict(cat='cpu_op', name='aten::mul', tid=1, ts=150.0, dur=1.0),
        dict(cat='python_function', name='f', tid=1, ts=90.0, dur=100.0),
        dict(cat='cuda_runtime', name='cudaLaunchKernel', tid=1, ts=106.0,
             dur=1.0),
    ])
    kind, total, rows = summarize_trace.summarize(trace, top=10)
    assert kind == 'cpu'
    got = {name: (us, n) for name, us, n in rows}
    assert got == {
        'sweep_p_cn_chain': (pytest.approx(50.0 - 20.25 - 19.999), 1),
        'aten::mm': (pytest.approx(20.25 - 5.125 + 19.999), 2),
        'aten::add': (pytest.approx(5.125 + 7.0), 2),
        'aten::mul': (pytest.approx(1.0), 1)}
    assert total == pytest.approx(50.0 + 7.0 + 1.0)
    assert [r[0] for r in rows] == ['aten::mm', 'aten::add',
                                    'sweep_p_cn_chain', 'aten::mul']


def test_summarize_trace_device_events(capsys):
    trace = chrome_trace([
        dict(cat='kernel', name='fb_grouped_kernel', tid=7, ts=10.0,
             dur=5.0),
        dict(cat='kernel', name='fb_grouped_kernel', tid=7, ts=20.0,
             dur=5.5),
        dict(cat='gpu_memcpy', name='Memcpy HtoD', tid=7, ts=30.0,
             dur=1.0),
        dict(cat='gpu_user_annotation', name='sweep_p_cn_chain', tid=7,
             ts=9.0, dur=20.0),
        dict(cat='cpu_op', name='aten::mm', tid=1, ts=0.0, dur=100.0),
    ])
    kind, total, rows = summarize_trace.summarize(trace, top=1)
    assert (kind, total) == ('device', 11.5)
    assert rows == [('fb_grouped_kernel', 10.5, 2)]


def test_profile_engine_trace_ranks_the_ranges(tmp_path, monkeypatch,
                                               capsys):
    outdir = str(tmp_path / 'trace')
    out = run_tool(profile_engine, SMALL + ['--iters', '2', '--outdir',
                                            outdir], tmp_path, monkeypatch)
    assert out['trace'] == os.path.join(outdir, 'trace.json')
    assert os.listdir(outdir) == ['trace.json']
    assert out['ms_per_sweep'] > 0
    printed = capsys.readouterr().out
    assert 'segments/s' in printed and 'trace written to' in printed

    kind, total, rows = summarize_trace.main([outdir, '--top', '200'])
    assert kind == 'cpu' and total > 0
    names = [name for name, _, _ in rows]
    assert set(eng.SWEEP_RANGES) <= set(names)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith('cpu self total')
    assert len(printed) == 2 + len(rows)
