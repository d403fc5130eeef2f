"""The port's restart grid (``remixt_tpu_torch.analysis.readdepth`` and
``pipeline.enumerate_restarts`` / ``init``) against the JAX package's on the
same TSVs, at N=600 over three seeds, without pinned depths.

The JAX package clusters the minor depths with scikit-learn's ``KMeans``
drawing from numpy's global generator, which its ``init`` seeds with
``random_seed``; the port's numpy k-means draws from
``np.random.RandomState(random_seed)`` in the same order and runs the same
algorithm. Only the order of its sums differs, so the depths are held at
``KMEANS_RTOL`` (measured: within 2.4e-15 relative on these problems, and
the labels identical); integer and categorical columns are exact.
"""

import pickle

import numpy as np
import pytest
import sklearn.cluster

from remixt_tpu.analysis import experiment as jax_experiment
from remixt_tpu.analysis import pipeline as jax_pipeline
from remixt_tpu.analysis import readdepth as jax_readdepth
from remixt_tpu.io.hdf5 import HDFStore as JaxStore
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch.analysis import experiment as torch_experiment
from remixt_tpu_torch.analysis import pipeline as torch_pipeline
from remixt_tpu_torch.analysis import readdepth as torch_readdepth
from remixt_tpu_torch.analysis.experiment import Experiment
from remixt_tpu_torch.io.hdf5 import HDFStore as TorchStore

from test_pipeline import make_tables

KMEANS_RTOL = 1e-10
SEED = 1234

CONFIGS = {
    'defaults': {},
    'narrow ploidy window': {'min_ploidy': 5.0, 'max_ploidy': 5.5,
                             'max_copy_number': 8},
    'smallest-mode anchor': {'normal_mode_mass_tolerance': 0.0,
                             'tumour_mix_fractions': [0.3, 0.1],
                             'divergence_weights': [1e-7]},
}


@pytest.fixture(scope='module', params=[0, 1, 2])
def problem(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_readdepth_{}'.format(request.param))
    data = sim.simulate_experiment(
        N=600, M=3, h=(0.08, 0.05, 0.025), cn_max=6, num_events=60,
        num_chains=6, seed=request.param)
    count_data, breakpoint_data = make_tables(data)
    count_file = str(tmp / 'counts.tsv')
    breakpoint_file = str(tmp / 'breakpoints.tsv')
    count_data.to_csv(count_file, sep='\t', index=False)
    breakpoint_data.to_csv(breakpoint_file, sep='\t', index=False)
    pair = {}
    for module, name in ((jax_experiment, 'jax'),
                         (torch_experiment, 'torch')):
        path = str(tmp / '{}.pickle'.format(name))
        module.create_experiment(count_file, breakpoint_file, path)
        with open(path, 'rb') as f:
            pair[name] = pickle.load(f)
    pair['files'] = {name: str(tmp / '{}.pickle'.format(name))
                     for name in ('jax', 'torch')}
    pair['tmp'] = tmp
    return pair


def test_calculate_depth_matches(problem):
    ref = jax_readdepth.calculate_depth(problem['jax'])
    got = torch_readdepth.calculate_depth(problem['torch'])
    assert got.columns == list(ref.columns)
    np.testing.assert_array_equal(got.index, ref.index.values)
    for name in ref.columns:
        if name == 'chromosome':
            assert list(got[name]) == [str(c) for c in ref[name]]
            continue
        assert got[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got[name], ref[name].values,
                                      err_msg=name)


def test_modes_candidates_ploidy_match(problem):
    ref_depth = jax_readdepth.calculate_depth(problem['jax'])
    np.random.seed(SEED)
    ref_modes, ref_masses = jax_readdepth.calculate_minor_modes(
        ref_depth, return_masses=True)
    modes, masses = torch_readdepth.calculate_minor_modes(
        torch_readdepth.calculate_depth(problem['torch']),
        return_masses=True, random_seed=SEED)
    assert len(modes) == len(ref_modes) >= 3
    np.testing.assert_allclose(modes, ref_modes, rtol=KMEANS_RTOL)
    np.testing.assert_array_equal(masses, ref_masses)

    ref_cands = jax_readdepth.calculate_candidate_h_monoclonal(
        ref_modes, mode_masses=ref_masses)
    cands = torch_readdepth.calculate_candidate_h_monoclonal(
        modes, mode_masses=masses)
    assert len(cands) == len(ref_cands) > 0
    np.testing.assert_allclose(np.array(cands), np.array(ref_cands),
                               rtol=KMEANS_RTOL)
    for h, ref_h in zip(cands, ref_cands):
        h3 = np.array([h[0], h[1] / 2, h[1] / 2])
        ref_h3 = np.array([ref_h[0], ref_h[1] / 2, ref_h[1] / 2])
        np.testing.assert_allclose(
            torch_readdepth.estimate_ploidy(h3, problem['torch']),
            jax_readdepth.estimate_ploidy(ref_h3, problem['jax']),
            rtol=KMEANS_RTOL)


@pytest.mark.parametrize('config', list(CONFIGS), ids=list(CONFIGS))
def test_enumerate_restarts_matches(problem, config):
    config = CONFIGS[config]
    np.random.seed(SEED)
    ref, _, _ = jax_pipeline.enumerate_restarts(problem['jax'], config)
    got, _, _ = torch_pipeline.enumerate_restarts(problem['torch'], config)
    assert len(got) == len(ref) > 0
    assert got.columns == list(ref.columns)
    for name in ('mode_idx', 'mix_frac', 'divergence_weight'):
        assert got[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got[name], ref[name].values,
                                      err_msg=name)
    for name in ('h_normal', 'h_tumour', 'ploidy_estimate', 'max_depth'):
        np.testing.assert_allclose(got[name], ref[name].values,
                                   rtol=KMEANS_RTOL, err_msg=name)


def test_init_matches_and_stores_read_each_other(problem):
    """``init`` of both packages: the same grid (as Python scalars) and init
    stores that either package reads."""
    tmp = problem['tmp']
    ref_params = jax_pipeline.init(str(tmp / 'jax_init.h5'),
                                   problem['files']['jax'], {})
    params = torch_pipeline.init(str(tmp / 'torch_init.h5'),
                                 problem['files']['torch'], {})
    assert list(params) == list(ref_params)
    for init_id, ref in ref_params.items():
        assert list(params[init_id]) == list(ref)
        for key, value in ref.items():
            assert type(params[init_id][key]) is type(value), key
            np.testing.assert_allclose(params[init_id][key], value,
                                       rtol=KMEANS_RTOL, err_msg=key)
    for path, store in ((str(tmp / 'torch_init.h5'), JaxStore),
                        (str(tmp / 'jax_init.h5'), TorchStore)):
        with store(path) as s:
            assert sorted(s.keys()) == ['/minor_modes', '/read_depth']
            assert len(s['read_depth']) > 0
    with JaxStore(str(tmp / 'jax_init.h5')) as j, \
            JaxStore(str(tmp / 'torch_init.h5')) as t:
        np.testing.assert_allclose(t['minor_modes'].values,
                                   j['minor_modes'].values, rtol=KMEANS_RTOL)
        np.testing.assert_array_equal(t['minor_modes'].index.values,
                                      j['minor_modes'].index.values)
        assert list(t['read_depth'].columns) == list(j['read_depth'].columns)
        np.testing.assert_array_equal(t['read_depth'].index.values,
                                      j['read_depth'].index.values)


@pytest.mark.parametrize('max_depth', [0.05, 0.12, 0.2, 0.3, 0.6])
def test_check_depth_coverage_refuses_the_same(problem, max_depth):
    outcomes = []
    for module, experiment in ((jax_pipeline, problem['jax']),
                               (torch_pipeline, problem['torch'])):
        try:
            module._check_depth_coverage(experiment, max_depth)
            outcomes.append(None)
        except ValueError as error:
            outcomes.append(str(error))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_kmeans_matches_scikit_learn(seed):
    """The port's k-means against ``KMeans(5, n_init=10)`` on one
    ``RandomState``: identical labels, centres at ``KMEANS_RTOL``."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.normal(m, 0.01, size=rng.randint(50, 3000))
                        for m in (0.08, 0.1, 0.13, 0.15, 0.19, 0.21)])
    centres, labels = torch_readdepth.kmeans_1d(
        x, 5, np.random.RandomState(seed + 10))
    ref = sklearn.cluster.KMeans(
        n_clusters=5, n_init=10,
        random_state=np.random.RandomState(seed + 10)).fit(x[:, None])
    np.testing.assert_array_equal(labels, ref.labels_)
    np.testing.assert_allclose(centres, ref.cluster_centers_[:, 0],
                               rtol=KMEANS_RTOL)


def test_init_needs_segment_coordinates():
    experiment = Experiment([[3, 1, 10]] * 4, [1e5] * 4,
                            {(0, 1), (1, 2), (2, 3)}, {})
    with pytest.raises(ValueError, match='coordinates'):
        torch_pipeline.init_tables(experiment, {})
