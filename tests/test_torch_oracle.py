"""The port's float64 oracle (``remixt_tpu_torch/models/oracle.py``) and its
float64 scan route, on the CPU.

(a) The port's copy of the oracle against the JAX package's: the problems
    of ``tests/test_oracle.py`` (its brute-force, monotone-ELBO, gradient,
    transition-model and telomere cases) run through both on the same
    inputs give the same numbers, bit for bit; and those tests' own checks
    hold for the port's copy.
(b) The port's engine on the scan route (``use_kernels=False``), float64,
    against the port's oracle over two sweeps, batched and one restart:
    posteriors, q(brk) and both outlier posteriors atol 1e-9, the log
    normalizer rtol 1e-10 and the ELBO rtol 1e-9, as
    ``tests/test_engine_parity.py`` holds the JAX engine to the oracle.
(c) A float64 fit on the scan route against the JAX float64 fit, batched
    (``fit_restarts_batched``) and one restart (``BreakpointModel.fit``),
    at the bars of ``test_torch_fit.py`` and ``test_torch_pipeline.py``:
    h rtol 1e-7, ELBO rtol 1e-8, posteriors atol 1e-9, decoded copy number
    exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
import test_oracle
from remixt_tpu.models import oracle as joracle
from remixt_tpu.models.fit import BreakpointModel as JaxModel
from remixt_tpu.models.fit_batched import (
    fit_restarts_batched as jax_fit_restarts_batched)
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch.models import engine as teng
from remixt_tpu_torch.models import oracle as toracle
from remixt_tpu_torch.models.fit import BreakpointModel
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched
from remixt_tpu_torch.ops import fb_chains, fb_grouped

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

# the problems of tests/test_oracle.py
ORACLE_PROBLEMS = (
    [dict(seed=s, N=5, M=2, cn_max=2, num_breakpoints=b)
     for s in (0, 1, 2) for b in (0, 1)]
    + [dict(seed=s, N=5, M=2, cn_max=2) for s in (3, 4)]
    + [dict(seed=s, **kw) for s in (0, 1) for kw in (
        dict(M=2, cn_max=2, num_breakpoints=1),
        dict(M=3, cn_max=2, num_breakpoints=2, N=8),
        dict(M=2, cn_max=2, num_breakpoints=1, normal_contamination=False))]
    + [dict(seed=7, N=6, M=3, cn_max=2, num_breakpoints=1),
       dict(seed=2, N=5, M=2, cn_max=2, num_breakpoints=1),
       dict(seed=5, N=6, M=2, cn_max=2, num_breakpoints=0, num_telomeres=1)])

ORACLE_FIELDS = ('posterior_marginals', 'joint_posterior_marginals',
                 'framelogprob', 'log_transmat', 'hmm_log_norm_const',
                 'p_breakpoint', 'p_outlier_total', 'p_outlier_allele',
                 'p_allele_swap')


def run_oracle(module, problem, transition_model=0):
    """Three sweeps of the reference's update order, with the ELBO, the
    expected log likelihood and its h gradient after each, and the Viterbi
    decode at the end."""
    model = module.OracleModel(**helpers.make_problem(**problem))
    if transition_model:
        model.transition_model = transition_model
        model.cached_log_transmat = model.calculate_log_transmat()
    sample = (np.random.RandomState(0).rand(model.num_segments) < 0.7
              ).astype(float)
    out = {'log_transmat_0': model.calculate_log_transmat()}
    for sweep in range(3):
        for update in ('update_p_allele_swap', 'update_p_cn',
                       'update_p_breakpoint', 'update_p_outlier_total',
                       'update_p_outlier_allele'):
            getattr(model, update)()
        for name in ORACLE_FIELDS:
            out['{}_{}'.format(name, sweep)] = np.array(getattr(model, name))
        out['elbo_{}'.format(sweep)] = model.calculate_elbo()
        out['ell_{}'.format(sweep)] = (
            model.calculate_expected_log_likelihood(sample))
        out['ell_grad_{}'.format(sweep)] = (
            model.calculate_expected_log_likelihood_partial_h(sample))
    out['viterbi'] = module.max_product(model.framelogprob,
                                        model.log_transmat)
    return out


@pytest.mark.parametrize('transition_model', [0, 1])
@pytest.mark.parametrize('problem', ORACLE_PROBLEMS,
                         ids=lambda p: '-'.join(map(str, p.values())))
def test_oracle_equals_jax_oracle(problem, transition_model):
    got = run_oracle(toracle, problem, transition_model)
    ref = run_oracle(joracle, problem, transition_model)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        if key == 'viterbi':
            np.testing.assert_array_equal(got[key][0], value[0])
            assert got[key][1] == value[1]
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


ORACLE_TESTS = [
    (test_oracle.test_sum_product_matches_brute_force,
     [dict(seed=s, num_breakpoints=b) for s in (0, 1, 2) for b in (0, 1)]),
    (test_oracle.test_max_product_matches_brute_force,
     [dict(seed=s) for s in (3, 4)]),
    (test_oracle.test_elbo_monotone_per_update,
     [dict(seed=s, kwargs=kw) for s in (0, 1) for kw in (
         dict(M=2, cn_max=2, num_breakpoints=1),
         dict(M=3, cn_max=2, num_breakpoints=2, N=8),
         dict(M=2, cn_max=2, num_breakpoints=1,
              normal_contamination=False))]),
    (test_oracle.test_partial_h_matches_numeric, [{}]),
    (test_oracle.test_transition_model_step, [{}]),
    (test_oracle.test_telomere_transitions_free, [{}]),
]


@pytest.mark.parametrize('test,kwargs', [
    (test, kwargs) for test, cases in ORACLE_TESTS for kwargs in cases],
    ids=lambda x: x.__name__ if callable(x) else
    '-'.join('{}={}'.format(k, v) for k, v in x.items()))
def test_oracle_tests_hold_for_the_port(monkeypatch, test, kwargs):
    """``tests/test_oracle.py``'s checks, with its oracle the port's."""
    monkeypatch.setattr(helpers, 'OracleModel', toracle.OracleModel)
    monkeypatch.setattr(test_oracle, 'oracle_mod', toracle)
    test(**kwargs)


ENGINE_CASES = [
    dict(N=12, M=2, cn_max=2, num_breakpoints=2),
    dict(N=10, M=3, cn_max=2, num_breakpoints=1),
    dict(N=12, M=2, cn_max=3, num_breakpoints=0),
    dict(N=10, M=2, cn_max=2, num_breakpoints=2, normal_contamination=False),
    dict(N=14, M=2, cn_max=2, num_breakpoints=2, num_telomeres=3),
]


def scan_pair(seed, case):
    prob = helpers.make_problem(seed=seed, **case)
    oracle = toracle.OracleModel(**prob)
    spec = teng.ModelSpec(
        dtype=torch.float64, device='cpu', use_kernels=False,
        **{k: prob[k] for k in (
            'cn_states', 'brk_states', 'l', 'x', 'y', 'is_telomere',
            'breakpoint_idx', 'breakpoint_orient', 'transition_penalty',
            'normal_contamination')})
    params = spec.init_params(prob['h_init'], prob['divergence_weight'])
    return oracle, spec, params, spec.init_state()


def assert_state_matches_oracle(spec, params, state, oracle, msg):
    for name in ('posterior_marginals', 'p_allele_swap', 'p_outlier_total',
                 'p_outlier_allele') + (('p_breakpoint',) if spec.K else ()):
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   getattr(oracle, name), atol=1e-9,
                                   err_msg='{} {}'.format(name, msg))
    np.testing.assert_allclose(float(state.hmm_log_norm_const),
                               oracle.hmm_log_norm_const, rtol=1e-10,
                               err_msg=msg)
    np.testing.assert_allclose(float(teng.calculate_elbo(spec, params, state)),
                               oracle.calculate_elbo(), rtol=1e-9,
                               err_msg=msg)


@pytest.mark.parametrize('batched', [False, True],
                         ids=['one_restart', 'batched'])
@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('case', range(len(ENGINE_CASES)))
def test_scan_route_matches_oracle(case, seed, batched, monkeypatch):
    """Two sweeps of the engine on the scan route against the oracle's;
    no kernel wrapper runs."""
    def no_kernel(*args, **kwargs):
        raise AssertionError('the scan route ran a kernel wrapper')

    monkeypatch.setattr(fb_grouped, 'forward_backward_chains_grouped',
                        no_kernel)
    monkeypatch.setattr(fb_chains, 'forward_backward_chains', no_kernel)
    oracle, spec, params, state = scan_pair(seed, ENGINE_CASES[case])
    for sweep in range(2):
        for update in ('update_p_allele_swap', 'update_p_cn',
                       'update_p_breakpoint', 'update_p_outlier_total',
                       'update_p_outlier_allele'):
            getattr(oracle, update)()
        if batched:
            state = teng.take(teng.variational_sweeps_restarts(
                spec, teng.one(params), teng.one(state), 1), 0)
        else:
            state = teng.variational_sweep(spec, params, state)
        assert_state_matches_oracle(spec, params, state, oracle,
                                    'sweep {}'.format(sweep))


MODEL_KWARGS = dict(max_copy_number=6, max_depth=1e9, min_segment_length=0.0,
                    min_proportion_genotyped=0.0, divergence_weight=1e-7,
                    random_seed=1234)
H_SCALES = (np.array([1.05, 0.95, 1.02]), np.array([0.9, 1.1, 0.97]))


@pytest.fixture(scope='module')
def sim_data():
    return sim.simulate_experiment(N=60, M=3, h=(0.08, 0.05, 0.025),
                                   cn_max=6, negbin_r=2000., betabin_M=2000.,
                                   frac_genotyped=0.5, seed=11)


def models(data):
    args = (data['x'], data['l'], data['adjacencies'], data['breakpoints'])
    jm = JaxModel(*args, dtype=jnp.float64, **MODEL_KWARGS)
    tm = BreakpointModel(*args, dtype=torch.float64, device='cpu',
                         use_kernels=False, **MODEL_KWARGS)
    for model in (jm, tm):
        model.num_em_iter = model.num_update_iter = 2
    return jm, tm


def assert_fits_match(tm, jm):
    """h rtol 1e-7, ELBO rtol 1e-8, posteriors atol 1e-9, decoded copy
    number exact."""
    np.testing.assert_allclose(tm.h, np.asarray(jm.h), rtol=1e-7)
    np.testing.assert_allclose(tm.prev_elbo, jm.prev_elbo, rtol=1e-8)
    np.testing.assert_allclose(tm.state.posterior_marginals.numpy(),
                               np.asarray(jm.state.posterior_marginals),
                               atol=1e-9)
    cn, brk = tm.optimal_cn()
    cn_ref, brk_ref = jm.optimal_cn()
    np.testing.assert_array_equal(cn, cn_ref)
    assert set(brk) == set(brk_ref)
    for k, value in brk_ref.items():
        np.testing.assert_array_equal(brk[k], value)


def test_single_restart_fit_on_the_scan_route_matches_jax(sim_data):
    jm, tm = models(sim_data)
    assert not tm.use_kernels
    launches = (fb_grouped.LAUNCHES, fb_chains.LAUNCHES)
    jm.fit(sim_data['h'] * H_SCALES[0])
    tm.fit(sim_data['h'] * H_SCALES[0])
    assert not tm.spec.use_kernels
    assert (fb_grouped.LAUNCHES, fb_chains.LAUNCHES) == launches
    assert_fits_match(tm, jm)


def test_batched_fit_on_the_scan_route_matches_jax(sim_data):
    jm, tm = models(sim_data)
    h_inits = [sim_data['h'] * s for s in H_SCALES]
    weights = [1e-7, 1e-6]
    ref = jax_fit_restarts_batched(jm, h_inits, weights, chunk_size=2)
    got = fit_restarts_batched(tm, h_inits, weights, chunk_size=2)
    assert not tm.spec.use_kernels
    for r, (g, j) in enumerate(zip(got, ref)):
        for model, result in ((tm, g), (jm, j)):
            model.params, model.state = result['params'], result['state']
            model.prev_elbo = result['elbo']
        assert_fits_match(tm, jm)
