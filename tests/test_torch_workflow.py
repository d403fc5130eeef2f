"""The port's ``fit`` CLI (``remixt_tpu_torch.ui.fit.fit``) against the
JAX package's (``remixt_tpu.ui.fit.fit``) on the same TSVs and YAML config:
``tests/test_cli.py``'s problem (N=40, float64, pinned depths), with its
one-restart grid and with a batched grid of four restarts. Both results
files are read with the JAX package's ``HDFStore``.

Tolerances: copy number and every column derived from the counts alone
exact; ``h``, ``mix``, the likelihood parameters and the columns derived
from ``h`` at rtol 1e-7; ``elbo`` at rtol 1e-8; the outlier probabilities
at atol 1e-7 (the fits' own tolerances, ``test_torch_pipeline.py``); and
``minor_modes`` at the k-means tolerance of ``test_torch_readdepth.py``.
The JAX side runs without a device mesh, whose results are a known defect
of the reference (``test_fit_many_device_mesh_matches_single_device``).
"""

import os
import time

import numpy as np
import pytest
import torch
import yaml

import remixt_tpu.ui.fit
import remixt_tpu_torch.ui.fit
from remixt_tpu.io.hdf5 import HDFStore as JaxStore
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch import workflow
from remixt_tpu_torch.io import hdf5 as torch_hdf5
from remixt_tpu_torch.io.table import Series, Table
from remixt_tpu_torch.ui import main as torch_main

from test_cli import _write_tables
from test_torch_readdepth import KMEANS_RTOL

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

CONFIG = {
    'max_copy_number': 6,
    'num_em_iter': 1,
    'num_update_iter': 2,
    'likelihood_min_segment_length': 1.0,
    'divergence_weights': [1e-7],
    'tumour_mix_fractions': [0.4],
    'engine_dtype': 'float64',
    'min_ploidy': 1.0,
    'max_ploidy': 8.0,
    'h_normal': 0.08,
    'h_tumour': 0.075,
    'use_device_mesh': False,
}
GRIDS = {
    'one restart': {},
    'batched, four restarts': {'divergence_weights': [1e-6, 1e-7],
                               'tumour_mix_fractions': [0.45, 0.3]},
}
COUNT_COLUMNS = {
    'chromosome', 'start', 'end', 'length', 'major_readcount',
    'minor_readcount', 'readcount', 'allele_ratio', 'major_depth',
    'minor_depth', 'total_depth', 'major_is_allele_a',
    'total_likelihood_mask', 'allele_likelihood_mask'}
OUTLIER_COLUMNS = {'prob_is_outlier_total', 'prob_is_outlier_allele'}


@pytest.fixture(scope='module', params=list(GRIDS), ids=list(GRIDS))
def results(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_workflow')
    data = sim.simulate_experiment(
        N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
        negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=7)
    count_file, breakpoint_file = _write_tables(tmp, data)
    config_file = str(tmp / 'config.yaml')
    with open(config_file, 'w') as f:
        yaml.dump(dict(CONFIG, **GRIDS[request.param]), f)

    files = {}
    for name, fit, kwargs in (
            ('jax', remixt_tpu.ui.fit.fit, {}),
            ('torch', remixt_tpu_torch.ui.fit.fit, {'device': 'cpu'})):
        files[name] = str(tmp / '{}.h5'.format(name))
        fit(count_file=count_file, breakpoint_file=breakpoint_file,
            results_file=files[name], work_dir=str(tmp / name),
            config=config_file, min_length=None, **kwargs)
    return dict(tmp=tmp, files=files, count_file=count_file,
                breakpoint_file=breakpoint_file, config_file=config_file,
                num_restarts=len(GRIDS[request.param].get(
                    'divergence_weights', [0])) ** 2)


def read(path):
    with JaxStore(path) as store:
        return {key: store[key] for key in store.keys()}


def assert_close(got, ref, key, name, rtol=None, atol=None):
    label = '{} {}'.format(key, name)
    if rtol is None and atol is None:
        np.testing.assert_array_equal(got, ref, err_msg=label)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol or 0, atol=atol or 0,
                                   err_msg=label)


def test_results_layout_matches(results):
    ref, got = read(results['files']['jax']), read(results['files']['torch'])
    assert list(got) == list(ref)
    solutions = sorted(k for k in ref if k.startswith('/solutions/'))
    assert len(solutions) == 4 * results['num_restarts']
    for key, table in ref.items():
        assert type(got[key]) is type(table), key
        np.testing.assert_array_equal(got[key].index.values,
                                      table.index.values, err_msg=key)
        assert got[key].index.dtype == table.index.dtype, key
        if hasattr(table, 'columns'):
            assert list(got[key].columns) == list(table.columns), key
            for name in table.columns:
                assert got[key][name].dtype == table[name].dtype, (key, name)
        else:
            assert got[key].dtype == table.dtype, key


def test_results_values_match(results):
    assert_stores_match(results['files']['jax'], results['files']['torch'])


def assert_stores_match(jax_file, torch_file):
    """Every table of the port's results store ``torch_file`` against the
    JAX package's ``jax_file``, at the tolerances above."""
    ref, got = read(jax_file), read(torch_file)
    assert list(got) == list(ref)
    stats = ref['/stats']
    params = [c for c in stats.columns if c.startswith(
        ('negbin', 'betabin', 'hdel', 'loh', 'p_outlier', 'r_', 'M_'))]
    assert params
    for key, table in ref.items():
        if key == '/minor_modes':
            assert_close(got[key].values, table.values, key, 'values',
                         rtol=KMEANS_RTOL)
        elif key.endswith(('/h', '/mix')):
            assert_close(got[key].values, table.values, key, 'values',
                         rtol=1e-7)
        elif key == '/stats':
            for name in table.columns:
                tol = ({'rtol': 1e-8} if name in ('elbo', 'elbo_diff')
                       else {'rtol': 1e-7} if name in params
                       or name in ('ploidy', 'proportion_divergent')
                       else {})
                if name == 'elbo_diff':
                    # a difference of ELBOs: the ELBO's tolerance, absolute
                    tol = {'atol': 1e-8 * np.abs(table['elbo'].values).max()}
                assert_close(got[key][name].values, table[name].values, key,
                             name, **tol)
        elif key == '/read_depth' or key.endswith('brk_cn'):
            for name in table.columns:
                assert_close(got[key][name].values, table[name].values, key,
                             name)
        else:
            for name in table.columns:
                exact = (name in COUNT_COLUMNS
                         or name.startswith(('major_', 'minor_'))
                         and name[6:].isdigit()
                         or name in ('major_diff', 'minor_diff'))
                tol = ({} if exact else {'atol': 1e-7}
                       if name in OUTLIER_COLUMNS else {'rtol': 1e-7})
                assert_close(got[key][name].values, table[name].values, key,
                             name, **tol)


def test_stores_read_each_other(results):
    """The port's store reads the JAX file as the JAX store does, and the
    JAX store reads the port's file (``read`` above)."""
    ref = read(results['files']['jax'])
    got = torch_hdf5.read_store(results['files']['jax'])
    assert ['/' + k for k in got] == list(ref)
    for key, table in ref.items():
        value = got[key.lstrip('/')]
        np.testing.assert_array_equal(value.index, table.index.values)
        if isinstance(value, Series):
            np.testing.assert_array_equal(value.values, table.values)
            continue
        assert isinstance(value, Table)
        assert value.columns == list(table.columns)
        for name in table.columns:
            if table[name].dtype.kind in 'biuf':
                assert value[name].dtype == table[name].dtype
            assert list(value[name]) == list(table[name].values), (key, name)


def test_rerun_skips_every_task(results):
    """The workflow run again on its work directory skips every task and
    rewrites nothing. (The CLI itself rebuilds the experiment first, so its
    tasks rerun, as the JAX CLI's do.)"""
    tmp = results['tmp']
    work_dir = str(tmp / 'torch')
    with open(results['config_file']) as f:
        config = yaml.safe_load(f)
    before = os.path.getmtime(results['files']['torch'])
    t0 = time.time()
    workflow.create_fit_model_workflow(
        os.path.join(work_dir, 'experiment.pickle'), results['files']['torch'],
        config, None, os.path.join(work_dir, 'fit'), device='cpu',
    ).run(work_dir)
    assert time.time() - t0 < 10.0
    assert os.path.getmtime(results['files']['torch']) == before


def test_main_registers_fit_only(capsys):
    """The port's subcommands: ``fit``, ``run`` since the run path was
    ported, ``write_results`` and ``visualize_solutions`` since the
    results CLI was, and ``create_ref_data`` and ``mappability_bwa`` since
    the reference build was."""
    with pytest.raises(SystemExit) as exit_info:
        torch_main.main(['--help'])
    assert exit_info.value.code == 0
    assert ('{fit,run,write_results,visualize_solutions,create_ref_data,'
            'mappability_bwa}') in capsys.readouterr().out


def test_write_store_without_h5py(monkeypatch, tmp_path):
    """Where h5py is missing, the store raises a clear ImportError and
    writes nothing."""
    import sys
    monkeypatch.setitem(sys.modules, 'h5py', None)
    path = str(tmp_path / 'results.h5')
    with pytest.raises(ImportError, match='needs h5py'):
        torch_hdf5.write_store(path, {'stats': Table([('a', [1])])})
    assert not os.path.exists(path)
