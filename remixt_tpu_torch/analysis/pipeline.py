"""Fit pipeline: the restart-grid fit, the one-restart fit job and
per-restart results (torch).

Counterpart of ``fit_task``, ``fit``, ``fit_many`` and their helpers in
``remixt_tpu/analysis/pipeline.py``. The grid runs through the batched
restart fit (``models/fit_batched.py``) in padded waves, or one restart
at a time through ``BreakpointModel.fit`` on one shared model
(``batch_restarts: false``, a grid of one restart,
``optimal_initialization``).
"""

import os
import pickle

import numpy as np

import remixt_tpu_torch.config
from remixt_tpu_torch.device import resolve_device, resolve_dtype
from remixt_tpu_torch.models.fit import (
    BreakpointModel, decode_breakpoints_naive)
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched


def fit_task(results_filename, experiment_filename, init_params, config,
             device=None):
    """One-restart fit job: fits the pickled
    :class:`~remixt_tpu_torch.analysis.experiment.Experiment` and pickles
    its results. A snapshot is written next to the results after every EM
    iteration, a killed job resumes from it, and it is removed once the
    results are on disk."""
    with open(experiment_filename, 'rb') as f:
        experiment = pickle.load(f)
    snapshot_filename = results_filename + '.ckpt'
    fit_results = fit(experiment, init_params, config,
                      snapshot_filename=snapshot_filename, device=device)
    with open(results_filename, 'wb') as f:
        pickle.dump(fit_results, f)
    if os.path.exists(snapshot_filename):
        os.remove(snapshot_filename)


def fit(experiment, init_params, config, snapshot_filename=None, device=None):
    """Fit one restart."""
    model = build_model(experiment, init_params, config, device)
    return fit_with_model(model, experiment, init_params, config,
                          snapshot_filename=snapshot_filename)


def fit_many(experiment, init_params_dict, config, device=None):
    """Fit every restart of the grid on one shared model.

    Args:
        experiment: an :class:`~remixt_tpu_torch.analysis.experiment.Experiment`
        init_params_dict: {init_id: dict with h_normal, h_tumour, mix_frac,
            divergence_weight, max_depth, mode_idx}
        config: config dict overlaying :mod:`remixt_tpu_torch.defaults`
        device: torch device; ``None`` means CUDA and raises without one

    Returns {init_id: fit_results}.
    """
    device = resolve_device(device)
    batched = remixt_tpu_torch.config.get_param(config, 'batch_restarts') \
        and not config.get('optimal_initialization', False)
    if batched and len(init_params_dict) > 1:
        return _fit_many_batched(experiment, init_params_dict, config, device)

    results = {}
    model = None
    for init_id, init_params in init_params_dict.items():
        if model is None:
            model = build_model(experiment, init_params, config, device)
        else:
            model.reset_restart(
                max_depth=init_params['max_depth'],
                divergence_weight=init_params['divergence_weight'])
        results[init_id] = fit_with_model(model, experiment, init_params,
                                          config)
    return results


def _restart_h_init(init_params):
    return np.array([
        init_params['h_normal'],
        init_params['h_tumour'] * init_params['mix_frac'],
        init_params['h_tumour'] * (1. - init_params['mix_frac']),
    ])


def _fit_many_batched(experiment, init_params_dict, config, device):
    init_ids = list(init_params_dict.keys())
    first = init_params_dict[init_ids[0]]
    model = build_model(experiment, first, config, device)
    model.breakpoint_init = None

    raw = fit_restarts_batched(
        model,
        [_restart_h_init(init_params_dict[i]) for i in init_ids],
        [init_params_dict[i]['divergence_weight'] for i in init_ids],
        chunk_size=remixt_tpu_torch.config.get_param(
            config, 'restart_chunk_size'))

    results = {}
    for init_id, restart in zip(init_ids, raw):
        model.params = restart['params']
        model.state = restart['state']
        model.prev_elbo = restart['elbo']
        model.prev_elbo_diff = restart['elbo_diff']
        model.divergence_weight = init_params_dict[init_id][
            'divergence_weight']
        results[init_id] = _extract_results(
            model, experiment, init_params_dict[init_id], config)
    return results


def build_model(experiment, init_params, config, device=None):
    """Construct the BreakpointModel for a restart's configuration."""
    get = lambda name: remixt_tpu_torch.config.get_param(config, name)
    device = resolve_device(device)
    dtype = resolve_dtype(device, get('engine_dtype'))

    normal_copies = np.ones((experiment.l.shape[0], 2), dtype=int)
    if not get('is_female'):
        on_x = experiment.segment_chromosome_id == 'X'
        normal_copies[on_x] = [1, 0]
        if np.any(experiment.x[on_x, 0:2] > 0):
            raise ValueError('inconsistent allele read counts for '
                             'chromosome X')

    model = BreakpointModel(
        experiment.x,
        experiment.l,
        experiment.adjacencies,
        experiment.breakpoints,
        max_copy_number=get('max_copy_number'),
        normal_contamination=get('normal_contamination'),
        divergence_weight=init_params['divergence_weight'],
        min_segment_length=get('likelihood_min_segment_length'),
        min_proportion_genotyped=get('likelihood_min_proportion_genotyped'),
        max_depth=init_params['max_depth'],
        normal_copies=normal_copies,
        disable_breakpoints=get('disable_breakpoints'),
        do_h_update=get('do_h_update'),
        random_seed=config.get('random_seed', 1234),
        device=device,
        dtype=dtype,
    )
    model.num_em_iter = get('num_em_iter')
    model.num_update_iter = get('num_update_iter')
    return model


def _truth_breakpoint_init(experiment, h_init):
    """Convergence-testing hook: breakpoint posteriors seeded from the
    simulated truth, clone-swapped to match the h initialization. Needs an
    experiment from the genome simulation, which carries the truth."""
    if (getattr(experiment, 'genome_mixture', None) is None
            or getattr(experiment, 'h', None) is None):
        raise ValueError(
            'optimal_initialization needs an experiment from the genome '
            'simulation (with genome_mixture and h), which the port does '
            'not build yet')
    collection = experiment.genome_mixture.genome_collection
    truth = collection.collapsed_breakpoint_copy_number()
    for bp in experiment.genome_mixture.detected_breakpoints.values():
        truth.setdefault(bp, np.zeros((experiment.genome_mixture.M,)))
    if (experiment.h[1] < experiment.h[2]) != (h_init[1] < h_init[2]):
        truth = {bp: np.concatenate([cn[:1], cn[1:][::-1]])
                 for bp, cn in truth.items()}
    return truth


def fit_with_model(model, experiment, init_params, config,
                   snapshot_filename=None):
    """Run one restart on a (possibly shared) model and extract results."""
    h_init = _restart_h_init(init_params)
    model.breakpoint_init = (
        _truth_breakpoint_init(experiment, h_init)
        if config.get('optimal_initialization', False) else None)
    model.fit(h_init, snapshot_filename=snapshot_filename)
    return _extract_results(model, experiment, init_params, config)


def _extract_results(model, experiment, init_params, config):
    """Decode and package one fitted restart's results."""
    cn, brk_cn = model.optimal_cn()
    if remixt_tpu_torch.config.get_param(config, 'disable_breakpoints'):
        brk_cn = decode_breakpoints_naive(
            cn, experiment.adjacencies, experiment.breakpoints)

    # length-weighted composition stats over the tumour clones
    l = experiment.l
    tumour_cn = cn[:, 1:, :]
    ploidy = (tumour_cn.mean(axis=1).sum(axis=1) * l).sum() / l.sum()
    divergent = (tumour_cn.max(axis=1) != tumour_cn.min(axis=1)).sum(axis=1)
    proportion_divergent = (divergent * l).sum() / (2. * l.sum())

    stats = dict(model.get_likelihood_param_values())
    stats.update({
        'elbo': model.prev_elbo,
        'elbo_diff': model.prev_elbo_diff,
        'error_message': '',
        'num_clones': len(model.h),
        'num_segments': len(experiment.x),
        'ploidy': ploidy,
        'proportion_divergent': proportion_divergent,
        'mode_idx': init_params['mode_idx'],
        'divergence_weight': init_params['divergence_weight'],
    })

    return {
        'h': model.h,
        'cn': cn,
        'brk_cn': brk_cn,
        'p_outlier_total': model.p_outlier_total,
        'p_outlier_allele': model.p_outlier_allele,
        'total_likelihood_mask': model.total_likelihood_mask,
        'allele_likelihood_mask': model.allele_likelihood_mask,
        'stats': stats,
    }
