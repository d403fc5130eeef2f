"""The port's evaluation (``remixt_tpu_torch.simulations.pipeline``)
against the JAX package's: each ``evaluate_*`` on the same result tables
(a perfect prediction, a clone-swapped one, a single-clone caller, a
total-only caller and a noisy one) at rtol 1e-12; one chained run,
simulate → ``init`` → ``fit_many`` (float64 on the CPU, 1 EM × 1 VI, two
restarts of init's grid) → ``collate`` → evaluate, against the JAX chain
(decoded copy number exact, metrics at rtol 1e-9); and the evaluation and
merged stores in the JAX package's HDF5 layout.
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import remixt_tpu.simulations.pipeline as jax_pipeline
from remixt_tpu.analysis import pipeline as jax_fit_pipeline
from remixt_tpu.io.hdf5 import HDFStore as JaxStore
from remixt_tpu_torch.analysis import pipeline as torch_fit_pipeline
from remixt_tpu_torch.io import hdf5 as torch_hdf5
from remixt_tpu_torch.io.table import Series, Table
from remixt_tpu_torch.simulations import pipeline as torch_pipeline

from test_torch_readdepth import KMEANS_RTOL
from test_torch_simulations import PARAMS, assert_same_frame

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

SEED = 11
CONFIG = {'max_copy_number': 6, 'num_em_iter': 1, 'num_update_iter': 1,
          'engine_dtype': 'float64', 'use_device_mesh': False}
EVALUATIONS = ('cn_evaluation', 'brk_cn_evaluation', 'mix_results',
               'outlier_evaluation')


@pytest.fixture(scope='module')
def simulated(tmp_path_factory):
    """(JAX experiment, port experiment, directory holding both pickles)."""
    tmp = tmp_path_factory.mktemp('evaluation')
    params = dict(PARAMS, random_seed=SEED)
    jax_pipeline.simulate_experiment(str(tmp / 'jax.pickle'), None, params)
    torch_pipeline.simulate_experiment(str(tmp / 'torch.pickle'), None,
                                       params)
    loaded = []
    for name in ('jax', 'torch'):
        with open(tmp / '{}.pickle'.format(name), 'rb') as f:
            loaded.append(pickle.load(f))
    return loaded[0], loaded[1], tmp


def both(columns):
    """The same columns as a pandas DataFrame and a port Table."""
    return (pd.DataFrame(columns),
            Table([(k, np.asarray(v)) for k, v in columns.items()]))


def prediction(experiment, case, rng):
    """{column: values} of the cn table, of the brk_cn table, and the mix,
    for a prediction case built from the simulated truth."""
    mixture = experiment.genome_mixture
    cn = mixture.cn.copy()
    minimal = (mixture.genome_collection
               .collapsed_minimal_breakpoint_copy_number())
    ids = list(mixture.detected_breakpoints)
    brk = np.array([minimal.get(mixture.detected_breakpoints[i],
                                np.zeros(3)) for i in ids])
    mix = np.asarray(mixture.frac, dtype=float).copy()
    if case == 'clone-swapped':
        cn, brk, mix = cn[:, [0, 2, 1]], brk[:, [0, 2, 1]], mix[[0, 2, 1]]
    elif case == 'noisy':
        flip = rng.rand(*cn.shape[:2]) < 0.2
        cn = cn + flip[:, :, None] * rng.randint(0, 2, size=cn.shape)
        brk = brk + (rng.rand(*brk.shape) < 0.2)
        keep = rng.rand(len(ids)) < 0.7
        ids, brk = [i for i, k in zip(ids, keep) if k], brk[keep]
        mix = mix + 0.01 * rng.rand(3)
    coords = {'chromosome': mixture.segment_chromosome_id,
              'start': mixture.segment_start, 'end': mixture.segment_end}
    clones = [1] if case == 'single-clone' else [1, 2]
    if case == 'total-only':
        cn_columns = dict(coords, **{'total_{}'.format(m): cn[:, m].sum(1)
                                     for m in clones})
    else:
        cn_columns = dict(coords)
        for m in clones:
            cn_columns['major_{}'.format(m)] = cn[:, m].max(axis=1)
            cn_columns['minor_{}'.format(m)] = cn[:, m].min(axis=1)
    cn_columns['prob_is_outlier_total'] = rng.rand(len(cn))
    cn_columns['prob_is_outlier_allele'] = rng.rand(len(cn)) * 0.6
    brk_columns = {'prediction_id': np.array(ids, dtype=np.int64)}
    for m in clones:
        brk_columns['cn_{}'.format(m)] = brk[:, m].astype(np.int32)
    if case == 'single-clone':
        mix = np.array([mix[0], mix[1:].sum()])
    return cn_columns, brk_columns, mix


def assert_series_close(got, ref, rtol, msg=''):
    assert list(got.index) == [str(k) for k in ref.index], msg
    np.testing.assert_allclose(got.values.astype(float),
                               ref.values.astype(float), rtol=rtol,
                               err_msg=msg)


CASES = ['perfect', 'clone-swapped', 'single-clone', 'total-only', 'noisy']


@pytest.mark.parametrize('case', CASES)
def test_evaluate_results_matches_jax(simulated, case):
    ref_experiment, experiment, _ = simulated
    cn_columns, brk_columns, mix = prediction(
        ref_experiment, case, np.random.RandomState(CASES.index(case)))
    cn_frame, cn_table = both(cn_columns)
    brk_frame, brk_table = both(brk_columns)
    ref = jax_pipeline.evaluate_results(ref_experiment.genome_mixture,
                                        cn_frame, brk_frame, mix)
    got = torch_pipeline.evaluate_results(experiment.genome_mixture,
                                          cn_table, brk_table, mix)
    assert list(got) == list(ref)
    for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results'):
        assert_series_close(got[name], ref[name], 1e-12, name)
    assert_same_frame(got['brk_cn_table'], ref['brk_cn_table'])
    ref_outlier = jax_pipeline.evaluate_likelihood_results(ref_experiment,
                                                           cn_frame)
    got_outlier = torch_pipeline.evaluate_likelihood_results(experiment,
                                                             cn_table)
    assert_series_close(got_outlier['outlier_evaluation'],
                        ref_outlier['outlier_evaluation'], 1e-12)

    metrics = got['cn_evaluation'].to_dict()
    if case in ('perfect', 'clone-swapped'):
        assert metrics['proportion_cn_correct'] == pytest.approx(1.0)
        assert got['brk_cn_evaluation'].to_dict()[
            'brk_cn_correct_proportion'] == pytest.approx(1.0)
    elif case == 'noisy':
        assert metrics['proportion_cn_correct'] < 1.0
        # predictions missing from the caller's table count as zero copies
        table = got['brk_cn_table']
        missing = ~np.isin(table['prediction_id'],
                           brk_columns['prediction_id'])
        assert missing.any() and table['cn_1'].dtype == np.float64
        assert np.all(table['cn_1'][missing] == 0.0)


def test_evaluate_results_of_an_empty_prediction(simulated):
    _, experiment, _ = simulated
    cn_table = Table([(c, np.array([], dtype=object))
                      for c in ('chromosome', 'start', 'end')])
    got = torch_pipeline.evaluate_results(experiment.genome_mixture,
                                          cn_table, Table(), [0.5, 0.5])
    assert set(got) == {'brk_cn_evaluation', 'brk_cn_table',
                        'cn_evaluation', 'mix_results'}
    assert len(got['brk_cn_table']) == 0
    assert all(len(got[name].values) == 0 for name in (
        'brk_cn_evaluation', 'cn_evaluation', 'mix_results'))


@pytest.fixture(scope='module')
def chained(simulated):
    """Both chains: init, fit_many over the first two restarts of each
    package's own grid, collate (the JAX one through its store) and
    evaluate."""
    ref_experiment, experiment, tmp = simulated
    jax_init = jax_fit_pipeline.init(str(tmp / 'jax_init.h5'),
                                     str(tmp / 'jax.pickle'), CONFIG)
    init_params, init_tables = torch_fit_pipeline.init_tables(experiment,
                                                              CONFIG)
    first = list(jax_init)[:2]
    jax_fits = jax_fit_pipeline.fit_many(
        ref_experiment, {i: jax_init[i] for i in first}, CONFIG)
    fits = torch_fit_pipeline.fit_many(
        experiment, {i: init_params[i] for i in first}, CONFIG,
        device='cpu')

    fit_files = {}
    for init_id, results in jax_fits.items():
        fit_files[init_id] = str(tmp / 'jax_fit_{}.pickle'.format(init_id))
        with open(fit_files[init_id], 'wb') as f:
            pickle.dump(results, f)
    jax_results = str(tmp / 'jax_results.h5')
    jax_fit_pipeline.collate(jax_results, str(tmp / 'jax.pickle'),
                             str(tmp / 'jax_init.h5'), fit_files, CONFIG)
    jax_evaluation = str(tmp / 'jax_evaluation.h5')
    jax_pipeline.evaluate_results_task(
        jax_evaluation, jax_results,
        experiment_filename=str(tmp / 'jax.pickle'))

    tables = torch_fit_pipeline.collate_tables(experiment, fits, init_tables,
                                               CONFIG)
    evaluation = torch_pipeline.evaluate_tables(experiment, tables)
    return dict(jax_init=jax_init, init_params=init_params,
                jax_fits=jax_fits, fits=fits, jax_results=jax_results,
                jax_evaluation=jax_evaluation, tables=tables,
                evaluation=evaluation, tmp=tmp)


def test_chain_grid_and_fits_match_jax(chained):
    jax_init, init_params = chained['jax_init'], chained['init_params']
    assert list(init_params) == list(jax_init) and len(init_params) >= 2
    for init_id, ref in jax_init.items():
        for name, value in ref.items():
            np.testing.assert_allclose(init_params[init_id][name], value,
                                       rtol=KMEANS_RTOL, err_msg=name)
    for init_id, ref in chained['jax_fits'].items():
        got = chained['fits'][init_id]
        np.testing.assert_array_equal(got['cn'], ref['cn'])
        np.testing.assert_allclose(got['h'], ref['h'], rtol=1e-7)
        np.testing.assert_allclose(got['stats']['elbo'],
                                   ref['stats']['elbo'], rtol=1e-8)


def test_chain_evaluation_matches_jax(chained):
    evaluation = chained['evaluation']
    assert list(evaluation) == ['cn_evaluation', 'brk_cn_table',
                                'brk_cn_evaluation', 'mix_results',
                                'outlier_evaluation']
    with JaxStore(chained['jax_evaluation'], 'r') as store:
        for name in EVALUATIONS:
            assert_series_close(evaluation[name], store['/' + name], 1e-9,
                                name)
        ref_table = store['/brk_cn_table']
    got_table = evaluation['brk_cn_table']
    assert got_table.columns == list(ref_table.columns)
    for name in ref_table.columns:
        np.testing.assert_array_equal(got_table[name], ref_table[name].values,
                                      err_msg=name)


def test_evaluation_store_has_the_jax_layout(chained, tmp_path):
    """The port's task on the JAX results store writes the JAX task's
    evaluation store (read back by the JAX package's reader: keys, kinds,
    columns, dtypes, index and values); the port's own results store
    evaluates to the in-memory evaluation; and the merged stores of both
    evaluations have one layout."""
    tmp = chained['tmp']
    port_evaluation = str(tmp_path / 'torch_evaluation.h5')
    torch_pipeline.evaluate_results_task(
        port_evaluation, chained['jax_results'],
        experiment_filename=str(tmp / 'torch.pickle'))
    with JaxStore(port_evaluation, 'r') as got, \
            JaxStore(chained['jax_evaluation'], 'r') as ref:
        assert got.keys() == ref.keys()
        for key in ref.keys():
            a, b = got[key], ref[key]
            assert type(a) is type(b), key
            if isinstance(b, pd.Series):
                pd.testing.assert_series_equal(a, b, rtol=1e-12)
            else:
                pd.testing.assert_frame_equal(a, b)

    port_results = str(tmp_path / 'torch_results.h5')
    torch_hdf5.write_store(port_results, chained['tables'])
    own = str(tmp_path / 'torch_own_evaluation.h5')
    torch_pipeline.evaluate_results_task(
        own, port_results, experiment_filename=str(tmp / 'torch.pickle'))
    stored = torch_hdf5.read_store(own)
    assert set(stored) == set(chained['evaluation'])
    for name in EVALUATIONS:
        assert isinstance(stored[name], Series)
        np.testing.assert_array_equal(stored[name].values,
                                      chained['evaluation'][name].values)

    sim_defs = {'sim_a': dict(PARAMS, random_seed=SEED),
                'sim_b': dict(PARAMS, random_seed=SEED + 1, extra=[1, 2])}
    merged = {}
    for label, module, evaluation in (
            ('jax', jax_pipeline, chained['jax_evaluation']),
            ('torch', torch_pipeline, port_evaluation)):
        merged[label] = str(tmp_path / 'merged_{}.h5'.format(label))
        module.merge_evaluations(
            merged[label], sim_defs,
            {('sim_a', 'remixt'): evaluation, ('sim_b', 'remixt'): evaluation},
            ['sim_id', 'tool'])
    with JaxStore(merged['torch'], 'r') as got, \
            JaxStore(merged['jax'], 'r') as ref:
        assert got.keys() == ref.keys()
        for key in ref.keys():
            pd.testing.assert_frame_equal(got[key], ref[key], rtol=1e-12)


def test_evaluate_tables_of_a_mixture_has_no_outlier_evaluation(chained,
                                                                simulated):
    _, experiment, _ = simulated
    got = torch_pipeline.evaluate_tables(experiment.genome_mixture,
                                         chained['tables'])
    assert 'outlier_evaluation' not in got
    np.testing.assert_array_equal(
        got['cn_evaluation'].values,
        chained['evaluation']['cn_evaluation'].values)
