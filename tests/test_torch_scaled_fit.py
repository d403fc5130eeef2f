"""Both fit paths of the port with the scaled-linear chain forward-backward
switched on (``fb_grouped.SCALED_LINEAR``), on the CPU.

In float64, the port's batched ``fit_many`` (2 EM × 2 VI) and its
single-restart ``BreakpointModel.fit`` against the JAX package's fits on
``test_torch_fit.py``'s problem (N=60, max copy number 6, seed 11). The
JAX side runs its own CPU path, the log-space scan: the scaled recursion
is a drop-in for it and differs only on states far below a lane's maximum,
so the tolerances are those of the log-space parity tests (h rtol 1e-7,
ELBO rtol 1e-8, posteriors atol 1e-9, decoded copy number exact). The
port's fits ask for the kernel route (``use_kernels=True``: float64 takes
the scan by default), and every chain update of them must take the scaled
plain version.

In float32, the port's scaled single-restart fit against its own
log-space fit: posterior max-abs-diff ≤ 1e-3, the bound ``chip_smoke.py``
holds the float32 card path to.
"""

import functools

import numpy as np
import pytest
import torch

import remixt_tpu.models.fit_batched as jax_fit_batched
from remixt_tpu.analysis import pipeline as jax_pipeline
from remixt_tpu_torch.analysis import pipeline as torch_pipeline
from remixt_tpu_torch.analysis.experiment import Experiment
from remixt_tpu_torch.ops import fb_grouped

from test_torch_fit import fitted, jax_model, port_model, sim_data  # noqa: F401

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

CONFIG = {
    'max_copy_number': 6,
    'num_em_iter': 2,
    'num_update_iter': 2,
    'engine_dtype': 'float64',
    'likelihood_min_segment_length': 0.0,
    'likelihood_min_proportion_genotyped': 0.0,
    'restart_chunk_size': 4,
    'use_device_mesh': False,
}


def restart_grid(h):
    """Three restarts around the simulated h, with their divergence
    weights."""
    return {
        i: dict(mode_idx=0, h_normal=h[0] * s, h_tumour=(h[1] + h[2]) * s,
                mix_frac=h[1] / (h[1] + h[2]) * f, divergence_weight=w,
                max_depth=1e9)
        for i, (s, f, w) in enumerate(((1.0, 1.0, 1e-7), (1.05, 0.95, 1e-6),
                                       (0.97, 1.03, 1e-8)))}


@pytest.fixture
def scaled_only(monkeypatch):
    """Switch the scaled recursion on, make the log-space plain version
    raise, and count the scaled plain version's calls."""
    calls = []
    scaled = fb_grouped.fb_grouped_scaled_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return scaled(*args, **kwargs)

    def not_log_space(*args, **kwargs):
        raise AssertionError('the switch is on: no log-space chain update')

    monkeypatch.setattr(fb_grouped, 'SCALED_LINEAR', True)
    monkeypatch.setattr(fb_grouped, 'fb_grouped_reference', not_log_space)
    monkeypatch.setattr(fb_grouped, 'fb_grouped_scaled_reference', counted)
    return calls


def recording(monkeypatch, module, raw):
    """Record the per-restart results of ``module.fit_restarts_batched``."""
    fn = module.fit_restarts_batched

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        raw.extend(out)
        return out
    monkeypatch.setattr(module, 'fit_restarts_batched', wrapper)


def test_batched_fit_many_scaled_matches_jax(monkeypatch, sim_data,
                                              scaled_only):
    experiment = Experiment(sim_data['x'], sim_data['l'],
                            sim_data['adjacencies'], sim_data['breakpoints'])
    init_params = restart_grid(sim_data['h'])
    raw_jax, raw_port = [], []
    monkeypatch.setattr(torch_pipeline, 'BreakpointModel', functools.partial(
        torch_pipeline.BreakpointModel, use_kernels=True))
    recording(monkeypatch, jax_fit_batched, raw_jax)
    recording(monkeypatch, torch_pipeline, raw_port)
    ref = jax_pipeline.fit_many(experiment, init_params,
                                dict(CONFIG, batch_restarts=True))
    got = torch_pipeline.fit_many(experiment, init_params,
                                  dict(CONFIG, batch_restarts=True),
                                  device='cpu')

    sweeps = CONFIG['num_em_iter'] * CONFIG['num_update_iter']
    assert len(scaled_only) == sweeps       # one wave of 3 (padded to 4)
    assert set(got) == set(ref)
    for i in ref:
        msg = 'restart {}'.format(i)
        np.testing.assert_allclose(got[i]['h'], ref[i]['h'], rtol=1e-7,
                                   err_msg=msg)
        np.testing.assert_allclose(got[i]['stats']['elbo'],
                                   ref[i]['stats']['elbo'], rtol=1e-8,
                                   err_msg=msg)
        np.testing.assert_array_equal(got[i]['cn'], ref[i]['cn'],
                                      err_msg=msg)
        assert set(got[i]['brk_cn']) == set(ref[i]['brk_cn'])
        for bp, cn in ref[i]['brk_cn'].items():
            np.testing.assert_array_equal(got[i]['brk_cn'][bp], cn)
    assert len(raw_port) == len(raw_jax) == len(init_params)
    for p, j in zip(raw_port, raw_jax):
        np.testing.assert_allclose(
            p['state'].posterior_marginals.numpy(),
            np.asarray(j['state'].posterior_marginals), atol=1e-9)


def test_single_restart_fit_scaled_matches_jax(sim_data, scaled_only):
    jm = fitted(jax_model(sim_data), sim_data)
    tm = fitted(port_model(sim_data, use_kernels=True), sim_data)

    sweeps = tm.num_em_iter * tm.num_update_iter
    assert len(scaled_only) == sweeps
    np.testing.assert_allclose(tm.h, np.asarray(jm.h), rtol=1e-7)
    np.testing.assert_allclose(tm.prev_elbo, jm.prev_elbo, rtol=1e-8)
    np.testing.assert_allclose(tm.state.posterior_marginals.numpy(),
                               np.asarray(jm.state.posterior_marginals),
                               atol=1e-9)
    cn_ref, brk_ref = jm.optimal_cn()
    cn, brk = tm.optimal_cn()
    np.testing.assert_array_equal(cn, cn_ref)
    assert set(brk) == set(brk_ref)
    for k in brk_ref:
        np.testing.assert_array_equal(brk[k], brk_ref[k])


def test_f32_scaled_fit_close_to_log_space_fit(monkeypatch, sim_data):
    def fit32():
        from remixt_tpu_torch.models.fit import BreakpointModel
        from test_torch_fit import MODEL_KWARGS
        model = BreakpointModel(
            sim_data['x'], sim_data['l'], sim_data['adjacencies'],
            sim_data['breakpoints'], dtype=torch.float32, device='cpu',
            **MODEL_KWARGS)
        return fitted(model, sim_data).state.posterior_marginals.numpy()

    log_space = fit32()
    monkeypatch.setattr(fb_grouped, 'SCALED_LINEAR', True)
    scaled = fit32()
    assert scaled.dtype == np.float32
    assert np.abs(scaled - log_space).max() <= 1e-3
