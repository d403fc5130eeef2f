"""The port's fit budget, restart-scaling probe and standalone tools on the
CPU.

* ``fit_budget`` in both modes and ``probe_restart_scaling`` through
  ``main([..., '--device', 'cpu'])``: the JAX tools' keys (listed below
  with their lines in ``tools/``) with the port's renames, the EM
  iteration's ranges plus the unattributed time equal to its time; no file
  but ``--out``'s, the JAX artifacts unchanged (``run_tool``). The fits
  are cut to 1 EM × 1 VI here, their problem to N=30.
* ``create_segments``' TSV equals the JAX package's on the same reference
  (a gap table and a FASTA index, as ``tests/test_torch_prep.py`` builds
  it), with and without breakpoints.
* The viewer's HTML equals the JAX package's
  ``create_solutions_visualization`` on the same results store, built
  without serving it.
"""

import json

import pytest
import torch
import yaml

import remixt_tpu.analysis.segment as jax_segment
import remixt_tpu.visualize as jax_visualize
from remixt_tpu.simulations import simple as jax_sim
from remixt_tpu_torch.models import em as em_mod
from remixt_tpu_torch.tools import (create_segments, fit_budget, problem,
                                    probe_restart_scaling, remixt_viewer_app)

from test_cli import _write_tables
from test_torch_tools import port_keys, run_tool

# the tensors are small: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

TINY = ['--n', '30', '--events', '2', '--device', 'cpu']

EM_SCOPES = ('sweep_emissions', 'sweep_p_allele_swap', 'sweep_be_bank',
             'sweep_p_cn_chain', 'sweep_p_breakpoint',
             'sweep_p_outlier_total', 'sweep_p_outlier_allele',
             'em_h_search', 'em_h_full_guard', 'em_running_components',
             'em_grid_zoom', 'em_candidate_guard', 'em_elbo_assembly')
# tools/fit_budget.py:125-131 and :162, trace_em_iteration's keys and main's
# backend
JAX_FIT_TRACE_KEYS = (
    ['N', 'restarts', 'mode', 'em_iter_wall_ms', 'em_iter_device_ms']
    + [s + '_ms' for s in EM_SCOPES] + ['unattributed_ms', 'backend'])
# tools/fit_budget.py:174-272, main's phase timings
JAX_FIT_KEYS = [
    'N', 'restarts', 'shape_note', 'backend', 'compilation_cache',
    'full_fit_cold_s', 'full_fit_warm_s', 'host_pull_scalar_ms',
    'sweep5_ms', 'h_update_ms', 'param_weights_ms', 'params_update_ms',
    'elbo_ms', 'decode_ms', 'batched_grid_fit_cold_s',
    'batched_grid_fit_warm_s', 'b_sweep5_ms', 'b_h_update_ms',
    'b_param_weights_ms', 'b_params_update_ms', 'b_elbo_ms']


def fit_keys(jax_keys):
    """The port's: ``backend`` is the ``device`` record, and the
    ``compilation_cache`` key is gone with the cache."""
    return port_keys([k for k in jax_keys
                      if k not in ('backend', 'compilation_cache')])


@pytest.fixture
def short_fits(monkeypatch):
    """The tools' model at 1 EM x 1 VI, with one ascent step in the h
    update and one grid level in the parameter zoom (a profile's events
    are parsed in Python: the h update issues thousands of ops a step)."""
    def build_model(*args, **kwargs):
        model, data = problem.build_model(*args, **kwargs)
        model.num_em_iter = model.num_update_iter = 1
        return model, data
    monkeypatch.setattr(fit_budget, 'build_model', build_model)
    monkeypatch.setattr(em_mod, 'H_OUTER', 1)
    monkeypatch.setattr(em_mod, 'GRID_LEVELS', 1)


def test_fit_budget_trace(tmp_path, monkeypatch, short_fits):
    out_file = str(tmp_path / 'fit_trace.json')
    out = run_tool(fit_budget, TINY + [
        '--trace', '--restarts', '2', '--iters', '1', '--out', out_file],
        tmp_path, monkeypatch)
    with open(out_file) as f:
        assert json.load(f) == out
    assert set(out) == fit_keys(JAX_FIT_TRACE_KEYS)
    assert out['mode'] == 'trace' and out['restarts'] == 2
    assert out['device']['platform'] == 'cpu'
    ranges = sum(out[s + '_ms'] for s in EM_SCOPES)
    assert ranges + out['unattributed_ms'] == pytest.approx(
        out['em_iter_cpu_ms'], abs=2e-2)
    assert out['unattributed_ms'] >= 0.0
    assert all(out[s + '_ms'] > 0 for s in EM_SCOPES)


def test_fit_budget_phases(tmp_path, monkeypatch, short_fits):
    out = run_tool(fit_budget, TINY + ['--restarts', '2', '--iters', '1'],
                   tmp_path, monkeypatch)
    assert set(out) == fit_keys(JAX_FIT_KEYS)
    assert out['N'] == 30 and out['restarts'] == 2
    assert all(out[k] > 0 for k in out
               if k.endswith(('_s', '_ms')) and k != 'host_pull_scalar_ms')


def test_fit_budget_phases_without_the_batched_grid(tmp_path, monkeypatch,
                                                    short_fits):
    out = run_tool(fit_budget, TINY + ['--restarts', '0', '--iters', '1'],
                   tmp_path, monkeypatch)
    assert set(out) == fit_keys(
        [k for k in JAX_FIT_KEYS if not k.startswith(('b_', 'batched'))])


def test_probe_restart_scaling(tmp_path, monkeypatch, capsys):
    out_file = str(tmp_path / 'scaling.json')
    rows = run_tool(probe_restart_scaling, TINY + [
        '--iters', '1', '--out', out_file, '1', '2'], tmp_path, monkeypatch)
    with open(out_file) as f:
        assert json.load(f) == rows
    printed = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in printed] == rows
    # tools/probe_restart_scaling.py:28-62: the single sweep's row, one
    # row an R, the optimal wave's (the port adds its device record)
    assert [set(row) for row in rows] == [
        {'R', 'note', 'segments_per_s'},
        {'R', 'segments_per_s', 'per_restart_segments_per_s',
         'step_cost_vs_R1'},
        {'R', 'segments_per_s', 'per_restart_segments_per_s',
         'step_cost_vs_R1'},
        {'optimal_wave_R', 'note', 'device'}]
    assert [row.get('R') for row in rows[:3]] == [0, 1, 2]
    assert rows[1]['step_cost_vs_R1'] == 1.0
    assert rows[3]['optimal_wave_R'] in (1, 2)
    best = max(rows[1:3], key=lambda row: row['segments_per_s'])
    assert rows[3]['optimal_wave_R'] == best['R']


def test_probe_reports_a_wave_out_of_memory(tmp_path, monkeypatch):
    """A wave the device cannot hold is a row with its note; the probe
    goes on with the next R."""
    real = probe_restart_scaling.time_restart_batched_sweep

    def time_wave(spec, params, state, R, device, iters=5):
        if R == 2:
            raise torch.cuda.OutOfMemoryError('CUDA out of memory.\nmore')
        return real(spec, params, state, R, device, iters=iters)

    monkeypatch.setattr(probe_restart_scaling, 'time_restart_batched_sweep',
                        time_wave)
    rows = run_tool(probe_restart_scaling, TINY + ['--iters', '1', '2', '1'],
                    tmp_path, monkeypatch)
    assert rows[1] == {'R': 2, 'note': 'out_of_memory',
                       'error': 'CUDA out of memory.'}
    assert 'step_cost_vs_R2' in rows[2] and rows[3]['optimal_wave_R'] == 1


def write_reference(ref_dir):
    """A FASTA index with chromosomes 1, 2 and Y and a gap table, as
    ``tests/test_torch_prep.py`` writes them."""
    import gzip
    (ref_dir / 'genome.fa.fai').write_text(
        '1\t30000\t0\t60\t61\n2\t20000\t0\t60\t61\nY\t10000\t0\t60\t61\n')
    with gzip.open(ref_dir / 'gaps.txt.gz', 'wt') as f:
        f.write('0\t1\t5000\t6000\t0\tN\t1000\ttelomere\tno\n')
        f.write('0\t1\t21000\t21500\t0\tN\t500\tcontig\tno\n')
        f.write('0\tY\t2000\t3000\t0\tN\t1000\ttelomere\tno\n')
    return {'chromosomes': ['1', '2'], 'segment_length': 4000,
            'gap_table_filename': str(ref_dir / 'gaps.txt.gz'),
            'genome_fai_filename': str(ref_dir / 'genome.fa.fai')}


@pytest.mark.parametrize('with_breakpoints', [False, True])
def test_create_segments_equals_jax(tmp_path, with_breakpoints):
    config = write_reference(tmp_path)
    config_file = tmp_path / 'config.yaml'
    config_file.write_text(yaml.safe_dump(config))
    breakpoint_file = None
    argv = []
    if with_breakpoints:
        breakpoint_file = str(tmp_path / 'breakpoints.tsv')
        with open(breakpoint_file, 'w') as f:
            f.write('prediction_id\tchromosome_1\tstrand_1\tposition_1\t'
                    'chromosome_2\tstrand_2\tposition_2\n'
                    '0\t1\t+\t12345\t2\t-\t7777\n'
                    '1\t2\t-\t15001\t2\t+\t3210\n')
        argv = ['--breakpoint_filename', breakpoint_file]
    ref = str(tmp_path / 'jax_segments.tsv')
    got = str(tmp_path / 'segments.tsv')
    jax_segment.create_segments(ref, config, str(tmp_path),
                                breakpoint_filename=breakpoint_file)
    create_segments.main([str(tmp_path), got, '--config', str(config_file)]
                         + argv)
    with open(got, 'rb') as f, open(ref, 'rb') as g:
        assert f.read() == g.read()
    with open(got) as f:
        assert len(f.read().splitlines()) > 10


def test_viewer_html_equals_jax(tmp_path):
    """The report the viewer would serve, built from a results store of
    the port's fit CLI, byte for byte the JAX package's."""
    import remixt_tpu_torch.ui.fit

    data = jax_sim.simulate_experiment(
        N=30, M=3, h=(0.08, 0.05, 0.025), cn_max=4, negbin_r=2000.,
        betabin_M=2000., frac_genotyped=0.5, seed=7, num_chains=6)
    count_file, breakpoint_file = _write_tables(tmp_path, data)
    config_file = str(tmp_path / 'config.yaml')
    with open(config_file, 'w') as f:
        yaml.dump({'max_copy_number': 4, 'num_em_iter': 1,
                   'num_update_iter': 1,
                   'likelihood_min_segment_length': 1.0,
                   'divergence_weights': [1e-7],
                   'tumour_mix_fractions': [0.4], 'min_ploidy': 1.0,
                   'max_ploidy': 8.0, 'h_normal': 0.08,
                   'h_tumour': 0.075}, f)
    results = str(tmp_path / 'results.h5')
    remixt_tpu_torch.ui.fit.fit(
        count_file, breakpoint_file, results, str(tmp_path / 'work'),
        config=config_file, min_length=None, device='cpu')

    serve_dir = tmp_path / 'serve'
    serve_dir.mkdir()
    html = remixt_viewer_app.build(results, str(serve_dir))
    assert html == str(serve_dir / 'index.html')
    ref = str(tmp_path / 'jax.html')
    jax_visualize.create_solutions_visualization(results, ref)
    with open(html, 'rb') as f, open(ref, 'rb') as g:
        got, want = f.read(), g.read()
    assert got == want
    payload = json.loads(got.decode().split('const DATA = ', 1)[1]
                         .split(';\n', 1)[0])
    assert payload['best'] in payload['solutions']
