"""The port's restart-grid fit (``remixt_tpu_torch.analysis.pipeline.
fit_many``) against the JAX batched ``fit_many`` on the same experiment and
restart grid, in float64 on the CPU.

Tolerances are those the JAX package holds its batched fit to against
its sequential fit (``test_pipeline.py::
test_fit_many_batched_matches_sequential``): h rtol 1e-7, ELBO rtol 1e-8,
decoded copy number exact.
"""

import pickle

import numpy as np
import pytest
import torch

from remixt_tpu.analysis import pipeline as jax_pipeline
from remixt_tpu.analysis.experiment import Experiment as JaxExperiment
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch.analysis import pipeline as torch_pipeline
from remixt_tpu_torch.analysis.experiment import Experiment

from test_pipeline import make_tables

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)


CONFIG = {
    'max_copy_number': 6,
    'num_em_iter': 2,
    'num_update_iter': 2,
    'engine_dtype': 'float64',
    'tumour_mix_fractions': [0.45, 0.2],
    'divergence_weights': [1e-6, 1e-8],
}


@pytest.fixture(scope='module')
def problem(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_pipeline')
    data = sim.simulate_experiment(
        N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
        negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=9)
    count_data, breakpoint_data = make_tables(data)
    jax_experiment = JaxExperiment(count_data, breakpoint_data)
    experiment_filename = str(tmp / 'experiment.pickle')
    with open(experiment_filename, 'wb') as f:
        pickle.dump(jax_experiment, f)
    init_params = jax_pipeline.init(str(tmp / 'init.h5'), experiment_filename,
                                    CONFIG)
    assert len(init_params) >= 4
    experiment = Experiment(
        jax_experiment.x, jax_experiment.l, jax_experiment.adjacencies,
        jax_experiment.breakpoints, jax_experiment.segment_chromosome_id)
    return jax_experiment, experiment, init_params


def test_fit_many_matches_jax_batched(problem):
    jax_experiment, experiment, init_params = problem
    ref = jax_pipeline.fit_many(
        jax_experiment, init_params,
        dict(CONFIG, batch_restarts=True, use_device_mesh=False))
    got = torch_pipeline.fit_many(experiment, init_params, CONFIG,
                                  device='cpu')

    assert set(got.keys()) == set(ref.keys())
    for init_id in ref:
        msg = 'restart {}'.format(init_id)
        np.testing.assert_allclose(got[init_id]['h'], ref[init_id]['h'],
                                   rtol=1e-7, err_msg=msg)
        np.testing.assert_allclose(got[init_id]['stats']['elbo'],
                                   ref[init_id]['stats']['elbo'], rtol=1e-8,
                                   err_msg=msg)
        np.testing.assert_array_equal(got[init_id]['cn'], ref[init_id]['cn'],
                                      err_msg=msg)
        assert set(got[init_id]['brk_cn']) == set(ref[init_id]['brk_cn'])
        for bp_id, cn in ref[init_id]['brk_cn'].items():
            np.testing.assert_array_equal(got[init_id]['brk_cn'][bp_id], cn)


@pytest.mark.parametrize('config', [
    dict(batch_restarts=False), dict(optimal_initialization=True)])
def test_sequential_path_is_not_ported(problem, config):
    _, experiment, init_params = problem
    with pytest.raises(NotImplementedError):
        torch_pipeline.fit_many(experiment, init_params,
                                dict(CONFIG, **config), device='cpu')


def test_grid_of_one_is_not_ported(problem):
    _, experiment, init_params = problem
    first = next(iter(init_params))
    with pytest.raises(NotImplementedError):
        torch_pipeline.fit_many(experiment, {first: init_params[first]},
                                CONFIG, device='cpu')
