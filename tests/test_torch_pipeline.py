"""The port's fit pipeline (``remixt_tpu_torch.analysis.pipeline``): the
restart-grid fit, batched and sequential, against the JAX ``fit_many`` on
the same experiment and restart grid, in float64 on the CPU; the
one-restart job ``fit_task``; and the truth-seeded breakpoint
initialization.

Tolerances are those the JAX package holds its batched fit to against
its sequential fit (``test_pipeline.py::
test_fit_many_batched_matches_sequential``): h rtol 1e-7, ELBO rtol 1e-8,
decoded copy number exact.
"""

import functools
import pickle
import types

import numpy as np
import pytest
import torch

from remixt_tpu.analysis import pipeline as jax_pipeline
from remixt_tpu.analysis.experiment import Experiment as JaxExperiment
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch.analysis import pipeline as torch_pipeline
from remixt_tpu_torch.analysis.experiment import Experiment
from remixt_tpu_torch.ops import fb_chains, fb_grouped

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


def assert_results_match(got, ref):
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


@pytest.fixture(scope='module')
def port_fit(problem):
    """The port's fit_many over the problem's grid, batched or sequential,
    on the chain route ``use_kernels`` (``None``, the default: the scan in
    float64; each run once), with the number of calls of each chain
    forward-backward wrapper during the run."""
    _, experiment, init_params = problem
    runs = {}

    def run(batched, use_kernels=None):
        if (batched, use_kernels) not in runs:
            calls = {'fb_chains': 0, 'fb_grouped': 0}
            model_class = torch_pipeline.BreakpointModel
            originals = [(torch_pipeline, 'BreakpointModel', model_class)]
            torch_pipeline.BreakpointModel = functools.partial(
                model_class, use_kernels=use_kernels)
            for module, name, key in (
                    (fb_chains, 'forward_backward_chains', 'fb_chains'),
                    (fb_grouped, 'forward_backward_chains_grouped',
                     'fb_grouped')):
                fn = getattr(module, name)
                originals.append((module, name, fn))

                def counted(*args, _fn=fn, _key=key, **kwargs):
                    calls[_key] += 1
                    return _fn(*args, **kwargs)
                setattr(module, name, counted)
            try:
                results = torch_pipeline.fit_many(
                    experiment, init_params,
                    dict(CONFIG, batch_restarts=batched), device='cpu')
            finally:
                for module, name, fn in originals:
                    setattr(module, name, fn)
            runs[batched, use_kernels] = results, calls
        return runs[batched, use_kernels]
    return run


def test_fit_many_matches_jax_batched(problem, port_fit):
    jax_experiment, _, init_params = problem
    ref = jax_pipeline.fit_many(
        jax_experiment, init_params,
        dict(CONFIG, batch_restarts=True, use_device_mesh=False))
    assert_results_match(port_fit(True)[0], ref)


def test_fit_many_sequential_matches_jax_sequential(problem, port_fit):
    jax_experiment, _, init_params = problem
    ref = jax_pipeline.fit_many(jax_experiment, init_params,
                                dict(CONFIG, batch_restarts=False))
    assert_results_match(port_fit(False)[0], ref)


def test_fit_many_sequential_matches_batched(port_fit):
    """The sequential driver reseeds and re-initializes per restart, so
    each restart reproduces its row of the batched waves."""
    assert_results_match(port_fit(False)[0], port_fit(True)[0])


def test_each_path_runs_its_own_chain_forward_backward(problem, port_fit):
    """On the kernel route (asked for: float64 takes the scan by default)
    the sequential fit runs the single-restart chain once per sweep of
    every restart; the batched fit the restart-batched one per sweep of
    every wave."""
    _, _, init_params = problem
    sweeps = CONFIG['num_em_iter'] * CONFIG['num_update_iter']
    assert port_fit(False, True)[1] == {
        'fb_chains': len(init_params) * sweeps, 'fb_grouped': 0}
    waves = -(-len(init_params) // 8)     # restart_chunk_size defaults to 8
    assert port_fit(True, True)[1] == {'fb_chains': 0,
                                       'fb_grouped': waves * sweeps}


@pytest.mark.parametrize('batched', [True, False],
                         ids=['batched', 'sequential'])
def test_float64_default_route_is_the_scan_bit_for_bit(port_fit, batched):
    """A float64 CPU fit on the default route equals the same fit with
    ``use_kernels=False`` bit for bit, and calls no kernel wrapper."""
    got, calls = port_fit(batched)
    ref, _ = port_fit(batched, False)
    assert calls == {'fb_chains': 0, 'fb_grouped': 0}
    for init_id in ref:
        for key in ('h', 'cn'):
            np.testing.assert_array_equal(got[init_id][key],
                                          ref[init_id][key])
        assert got[init_id]['stats']['elbo'] == ref[init_id]['stats']['elbo']
        assert set(got[init_id]['brk_cn']) == set(ref[init_id]['brk_cn'])
        for bp_id, cn in ref[init_id]['brk_cn'].items():
            np.testing.assert_array_equal(got[init_id]['brk_cn'][bp_id], cn)


def test_grid_of_one_runs(problem, port_fit):
    _, experiment, init_params = problem
    first = next(iter(init_params))
    got = torch_pipeline.fit_many(experiment, {first: init_params[first]},
                                  CONFIG, device='cpu')
    assert_results_match(got, {first: port_fit(False)[0][first]})


def test_fit_task_round_trips_and_removes_its_snapshot(problem, port_fit,
                                                      tmp_path):
    _, experiment, init_params = problem
    first = next(iter(init_params))
    experiment_filename = str(tmp_path / 'experiment.pickle')
    with open(experiment_filename, 'wb') as f:
        pickle.dump(experiment, f)
    results_filename = str(tmp_path / 'results.pickle')
    torch_pipeline.fit_task(results_filename, experiment_filename,
                            init_params[first], CONFIG, device='cpu')
    assert not (tmp_path / 'results.pickle.ckpt').exists()
    with open(results_filename, 'rb') as f:
        got = pickle.load(f)
    assert_results_match({first: got}, {first: port_fit(False)[0][first]})


def test_optimal_initialization_needs_the_simulated_truth(problem):
    _, experiment, init_params = problem
    with pytest.raises(ValueError, match='genome_mixture'):
        torch_pipeline.fit_many(experiment, init_params,
                                dict(CONFIG, optimal_initialization=True),
                                device='cpu')


@pytest.mark.parametrize('h', [(0.1, 0.05, 0.02), (0.1, 0.02, 0.05)])
def test_truth_breakpoint_init_matches_jax(h):
    """On a stand-in for the genome simulation's experiment, with and
    without the clone swap."""
    truth = {'bp0': np.array([0, 1, 2]), 'bp1': np.array([0, 2, 0])}
    collection = types.SimpleNamespace(
        collapsed_breakpoint_copy_number=lambda: dict(truth))
    mixture = types.SimpleNamespace(
        genome_collection=collection, M=3,
        detected_breakpoints={0: 'bp0', 1: 'bp2'})
    experiment = types.SimpleNamespace(genome_mixture=mixture,
                                       h=np.array([0.1, 0.06, 0.03]))
    h_init = np.array(h)
    ref = jax_pipeline._truth_breakpoint_init(experiment, h_init)
    got = torch_pipeline._truth_breakpoint_init(experiment, h_init)
    assert set(got) == set(ref) == {'bp0', 'bp1', 'bp2'}
    for bp in ref:
        np.testing.assert_array_equal(got[bp], ref[bp])
