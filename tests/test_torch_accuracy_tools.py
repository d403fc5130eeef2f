"""The port's accuracy tools on the CPU at a tiny size.

(a) The accuracy gate (``remixt_tpu_torch.tools.accuracy_gate``), each
    mode through its command line at N=60, max copy number 4, one sweep
    and a 1 EM × 2 VI fit:
    a float64 engine equals the port's oracle (posterior atol 1e-9), the
    float64 engine as the reference gives the same figures as the oracle,
    the kernel route equals the scan route on the CPU (the kernels' plain
    versions), and the results file holds what was printed.
(b) ``tools/fit_restarts``: two restarts of the runner's tiny simulation
    fitted one at a time and in one batched wave at its config give the
    same h and ELBO (rtol 1e-8) and the same copy number.
(c) The benchmark runner and exporter
    (``remixt_tpu_torch.benchmark.{run_evaluation,export_evaluation}``)
    against the JAX package's ``benchmark/run_evaluation.py`` and
    ``export_evaluation.py``: one simulation (N=150, three chromosomes),
    float64, max copy number 6, 1 EM × 2 VI; the merged evaluation tables
    equal the JAX runner's at rtol 1e-7 (the simulations table exactly);
    the same run with its stores as directories of TSV tables, as where
    h5py is absent, gives the same tables; a rerun skips every task; the
    runner's summary line names the chosen restart; and the exporter's JSON
    equals the JAX exporter's on the JAX store (records exactly, the summary
    at rtol 1e-12).
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from remixt_tpu_torch.benchmark import export_evaluation, run_evaluation
from remixt_tpu_torch.io import store
from remixt_tpu_torch.tools import accuracy_gate, fit_restarts

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shallow_problem(monkeypatch):
    """The gate's problem at max copy number 4, its fit cut to 1 EM × 2
    VI."""
    make_problem = accuracy_gate.make_problem

    def shallow(*args, **kwargs):
        model, data = make_problem(*args, cn_max=4, **kwargs)
        model.num_em_iter, model.num_update_iter = 1, 2
        return model, data
    monkeypatch.setattr(accuracy_gate, 'make_problem', shallow)


@pytest.fixture(scope='module')
def gate_runs(tmp_path_factory):
    """Each mode of the gate through its command line, N=60, one sweep."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        shallow_problem(monkeypatch)
        out = tmp_path_factory.mktemp('gate')
        common = ['--n', '60', '--sweeps', '1', '--device', 'cpu']
        runs = {}
        for name, args in (
                ('oracle64', ['--oracle', '--dtype', 'float64']),
                ('engine64', ['--oracle', '--dtype', 'float64',
                              '--reference', 'engine']),
                ('em_kernels', ['--em', '--kernels'])):
            path = str(out / (name + '.json'))
            assert accuracy_gate.main(common + args + ['--out', path]) == 0
            with open(path) as f:
                runs[name] = json.load(f)
    return runs


def test_gate_float64_engine_equals_the_oracle(gate_runs):
    (entry,) = gate_runs['oracle64']
    assert entry['gate'] == 'float64_engine_vs_f64_oracle'
    assert entry['num_sweeps'] == 1
    last = entry['per_sweep'][-1]
    assert last['posterior_max_abs_diff'] <= 1e-9
    assert last['p_breakpoint_max_abs_diff'] <= 1e-9
    assert last['log_norm_rel_diff'] <= 1e-10
    assert accuracy_gate.check_thresholds(entry) == []


def test_gate_engine_reference_agrees_with_the_oracle(gate_runs):
    """A float64 engine against a float64 engine: the same sweeps from
    the same initialization agree exactly."""
    (entry,) = gate_runs['engine64']
    assert entry['gate'] == 'float64_engine_vs_f64_engine'
    last = entry['per_sweep'][-1]
    for key in ('posterior_max_abs_diff', 'p_breakpoint_max_abs_diff',
                'p_outlier_total_max_abs_diff', 'log_norm_rel_diff'):
        assert last[key] == 0.0, key


def test_gate_em_and_kernels(gate_runs):
    em, kernels = gate_runs['em_kernels']
    assert em['gate'] == 'f32_vs_f64_full_fit'
    assert (em['num_em_iter'], em['num_update_iter']) == (1, 2)
    assert np.isfinite([em['elbo_f32'], em['elbo_f64']]).all()
    assert em['elbo_rel_diff'] < 1e-3 and em['h_max_rel_diff'] < 1e-2
    assert em['f32_kernel_launches'] == em['f64_kernel_launches'] == 0
    assert em['f32_peak_gb'] is None
    assert 0.0 <= em['decode_disagreement_fraction'] <= 1.0
    assert kernels['gate'] == 'kernels_vs_scan_f32'
    # on the CPU the kernel route runs the kernels' plain versions, which
    # agree with the scan where the posteriors live
    assert kernels['posterior_max_abs_diff'] <= 1e-3


def test_gate_thresholds_fail_a_settled_float32_miss():
    entry = {'gate': 'float32_engine_vs_f64_oracle', 'per_sweep': [
        {'posterior_max_abs_diff': 1.0, 'posterior_argmax_disagreement': 0.0,
         'p_outlier_total_max_abs_diff': 0.0},
        {'posterior_max_abs_diff': 1e-3,
         'posterior_argmax_disagreement': 2e-2,
         'p_outlier_total_max_abs_diff': 0.0}]}
    failures = accuracy_gate.check_thresholds(entry)
    assert len(failures) == 1 and 'argmax' in failures[0]
    assert accuracy_gate.check_thresholds(
        dict(entry, gate='float64_engine_vs_f64_oracle')) == []


SIM_DEFS = {
    'defaults': dict(
        h_total=0.1, N=150, M=3, frac_normal=0.4, frac_clone_1=0.4,
        num_false_breakpoints=5, proportion_breakpoints_detected=0.9,
        num_ancestral_events=8, num_descendent_events=4,
        proportion_subclonal=0.3,
        chromosome_lengths={'1': 60000000, '2': 50000000, '3': 40000000}),
    'simulations': {'tiny': dict(num_simulations=1, num_replicates=1,
                                 random_seed_start=1234)},
}
CONFIG = {'num_em_iter': 1, 'num_update_iter': 2, 'max_copy_number': 6,
          'tumour_mix_fractions': [0.3], 'divergence_weights': [1e-7],
          'engine_dtype': 'float64', 'use_device_mesh': False}
EVALUATIONS = ('cn_evaluation', 'brk_cn_evaluation', 'mix_results',
               'outlier_evaluation')


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        'jax_' + name, os.path.join(REPO, 'benchmark', name + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX runner, and the port's with HDF5 stores and with TSV
    directories, on the same sim defs and config; the port's second run
    again on its own work directory."""
    root = tmp_path_factory.mktemp('runner')
    sim_defs, config = str(root / 'sim_defs.yaml'), str(root / 'config.yaml')
    for path, doc in ((sim_defs, SIM_DEFS), (config, CONFIG)):
        with open(path, 'w') as f:
            yaml.safe_dump(doc, f, sort_keys=False)
    out = {}

    jax_runner = load_jax_script('run_evaluation')
    argv = sys.argv
    sys.argv = ['run_evaluation.py', sim_defs, str(root / 'jax'),
                str(root / 'jax.h5'), '--config', config]
    try:
        jax_runner.main()
    finally:
        sys.argv = argv
    out['jax'] = str(root / 'jax.h5')

    args = [sim_defs, '--config', config, '--device', 'cpu']
    run_evaluation.main([args[0], str(root / 'port'), str(root / 'port.h5')]
                        + args[1:])
    out['port'] = str(root / 'port.h5')

    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(run_evaluation, 'store_name', lambda stem: stem)
        argv = [args[0], str(root / 'tsv'), str(root / 'tsv_table')] + args[1:]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run_evaluation.main(argv)
        out['summary'] = printed.getvalue().splitlines()[-1]
        out['tsv'] = str(root / 'tsv_table')
        t0 = time.time()
        run_evaluation.main(argv)
        out['rerun_seconds'] = time.time() - t0
    out['tsv_dir'] = str(root / 'tsv' / 'tiny_0_0')
    return out


def assert_tables_equal(got, ref, rtol):
    assert got.columns == ref.columns
    for name in ref.columns:
        a, b = got[name], ref[name]
        if b.dtype.kind == 'f':
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_runner_matches_the_jax_runner(runs):
    got, ref = store.read_store(runs['port']), store.read_store(runs['jax'])
    assert set(got) == set(ref)
    for name in EVALUATIONS:
        assert_tables_equal(got[name], ref[name], 1e-7)
    assert_tables_equal(got['simulations'], ref['simulations'], 0)
    assert 'brk_cn_table/tiny_0_0' in got


def test_runner_without_hdf5_stores(runs):
    """Stores as directories of TSV tables: the same merged tables, bit
    for bit; each simulation's stores are directories."""
    got, ref = store.read_store(runs['tsv']), store.read_store(runs['port'])
    assert sorted(got) == sorted(ref)
    for name in got:
        assert_tables_equal(got[name], ref[name], 0)
    for name in ('results', 'evaluation', 'fit/init_results'):
        assert os.path.isdir(os.path.join(runs['tsv_dir'], name)), name


def test_runner_rerun_skips_every_task(runs):
    assert runs['rerun_seconds'] < 10.0


def test_runner_reports_the_chosen_restarts(runs):
    """The summary line names each simulation's chosen restart, the one
    the results store's stats pick."""
    summary = json.loads(runs['summary'])
    assert summary['device'] == 'cpu' and summary['wall_seconds'] > 0
    stats = store.read_store(os.path.join(
        runs['tsv_dir'], 'results'))['stats']
    (chosen,) = summary['chosen'].values()
    best = int(np.argmax(stats['elbo']))
    assert chosen['elbo'] <= float(stats['elbo'][best])
    assert chosen['elbo'] in stats['elbo'].tolist()


def test_exporter_matches_the_jax_exporter(runs, tmp_path):
    jax_exporter = load_jax_script('export_evaluation')
    argv = sys.argv
    sys.argv = ['export_evaluation.py', runs['jax'], str(tmp_path / 'j.json')]
    try:
        jax_exporter.main()
    finally:
        sys.argv = argv
    with open(tmp_path / 'j.json') as f:
        ref = json.load(f)
    assert export_evaluation.main(
        [runs['jax'], str(tmp_path / 't.json')]) == 0
    with open(tmp_path / 't.json') as f:
        got = json.load(f)
    assert list(got) == list(ref)
    for name in ref:
        if name != 'summary':
            assert got[name] == ref[name], name
    assert got['summary'].keys() == ref['summary'].keys()
    for config, metrics in ref['summary'].items():
        assert got['summary'][config].keys() == metrics.keys()
        for metric, stats in metrics.items():
            for key, value in stats.items():
                np.testing.assert_allclose(got['summary'][config][metric][key],
                                           value, rtol=1e-12)


def test_exporter_compare_marks_misses(runs):
    document = export_evaluation.export(runs['port'])
    lines, outside = export_evaluation.compare(document, document)
    assert outside == 0
    assert len(lines) == len(export_evaluation.ACCURACY_BARS)
    moved = json.loads(json.dumps(document))
    moved['cn_evaluation'][0]['proportion_cn_correct'] += 0.05
    lines, outside = export_evaluation.compare(document, moved)
    assert outside == 1
    assert any(line.endswith('OUTSIDE') for line in lines)


def test_fit_restarts_single_equals_batched(tmp_path):
    sim_defs, config = (str(tmp_path / name)
                        for name in ('sim_defs.yaml', 'config.yaml'))
    for path, doc in ((sim_defs, SIM_DEFS), (config, CONFIG)):
        with open(path, 'w') as f:
            yaml.safe_dump(doc, f, sort_keys=False)
    lines = {}
    for batched in (False, True):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            fit_restarts.main(
                [sim_defs, 'tiny_0_0', '0', '3', '--dtype', 'float64',
                 '--device', 'cpu', '--work', str(tmp_path),
                 '--config', config]
                + (['--batched'] if batched else []))
        lines[batched] = [json.loads(l) for l in
                          printed.getvalue().splitlines()]
    single, batched = lines[False], lines[True]
    assert batched[-1]['batched'] and not single[-1]['batched']
    assert [r['init_id'] for r in single[:-1]] == [0, 3]
    for a, b in zip(single[:-1], batched[:-1]):
        np.testing.assert_allclose(a['h'], b['h'], rtol=1e-8)
        np.testing.assert_allclose(a['elbo'], b['elbo'], rtol=1e-8)
        assert a['cn'] == b['cn']
