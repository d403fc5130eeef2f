"""Fit pipeline: the restart grid, the restart-grid fit, the one-restart
fit job, and collation into the results store (numpy and torch).

Counterpart of ``remixt_tpu/analysis/pipeline.py`` without pandas: the
restart grid (minor-depth modes x tumour mix fractions, ploidy-filtered
with a common max depth, crossed with divergence weights), the per-restart
fits, and the results tables in the JAX package's HDF5 schema (``stats``,
``read_depth``, ``minor_modes``,
``solutions/solution_{i}/{cn,brk_cn,h,mix}`` and the chosen solution's
``cn``, ``mix`` and ``brk_cn``). ``init`` and ``collate`` are a table
builder (``init_tables``, ``collate_tables``, host-only numpy) followed by
the writer ``write_store`` (``io/store.py``: an HDF5 file, or a directory
of TSV tables where the store's name does not end in ``.h5``).

The grid runs through the batched restart fit (``models/fit_batched.py``)
in padded waves, or one restart at a time through ``BreakpointModel.fit``
on one shared model (``batch_restarts: false``, a grid of one restart,
``optimal_initialization``). A cohort of samples is fitted sample by
sample, one worker thread per device (``fit_many_cohort``).
"""

import contextlib
import os
import pickle

import numpy as np

import remixt_tpu_torch.config
from remixt_tpu_torch.analysis import experiment as experiment_tables
from remixt_tpu_torch.analysis import readdepth
from remixt_tpu_torch.device import resolve_device, resolve_dtype
from remixt_tpu_torch.io.store import read_store, write_store
from remixt_tpu_torch.io.table import Series, Table
from remixt_tpu_torch.models.fit import (
    BreakpointModel, decode_breakpoints_naive)
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched

INIT_COLUMNS = ['mode_idx', 'h_normal', 'h_tumour', 'mix_frac',
                'divergence_weight', 'max_depth']


def _load_pickle(filename):
    with open(filename, 'rb') as f:
        return pickle.load(f)


def enumerate_restarts(experiment, config):
    """The restart grid as a Table.

    One row per (minor-depth mode, tumour mix fraction, divergence weight)
    surviving the ploidy window (the modes nearest to it when none is
    inside), in that nesting order, all sharing the smallest per-mode
    maximum modellable depth so that the restarts' objectives compare.

    Returns (grid, read_depth table, minor_modes).
    """
    get = lambda name: remixt_tpu_torch.config.get_param(config, name)
    min_ploidy, max_ploidy = get('min_ploidy'), get('max_ploidy')

    read_depth = readdepth.calculate_depth(experiment)
    minor_modes, mode_masses = readdepth.calculate_minor_modes(
        read_depth, return_masses=True,
        random_seed=config.get('random_seed', 1234))
    h_candidates = readdepth.calculate_candidate_h_monoclonal(
        minor_modes, h_normal=get('h_normal'), h_tumour=get('h_tumour'),
        mode_masses=mode_masses,
        normal_mass_tolerance=get('normal_mode_mass_tolerance'))

    h_normal = np.array([h[0] for h in h_candidates], dtype=float)
    h_tumour = np.array([h[1] for h in h_candidates], dtype=float)
    ploidy = np.array([readdepth.estimate_ploidy(h, experiment)
                       for h in h_candidates], dtype=float)
    if not np.all(np.isfinite(ploidy)):
        raise ValueError('non-finite ploidy estimate')
    max_depth = 2. * h_normal + (get('max_copy_number') + 0.25) * h_tumour

    # distance to the allowed ploidy window; keep in-window modes, falling
    # back to the nearest modes when the window is empty
    distance = np.zeros(len(h_candidates))
    if min_ploidy is not None:
        distance = np.maximum(distance, np.clip(min_ploidy - ploidy, 0., None))
    if max_ploidy is not None:
        distance = np.maximum(distance, np.clip(ploidy - max_ploidy, 0., None))
    in_window = distance == 0.
    modes = np.flatnonzero(
        in_window if in_window.any() or len(distance) == 0
        else distance == distance.min())

    rows = [(m, mix_frac, weight)
            for m in modes
            for mix_frac in get('tumour_mix_fractions')
            for weight in get('divergence_weights')]
    mode_idx = np.array([r[0] for r in rows], dtype=np.int64)
    grid = Table([
        ('mode_idx', mode_idx),
        ('h_normal', h_normal[mode_idx]),
        ('h_tumour', h_tumour[mode_idx]),
        ('ploidy_estimate', ploidy[mode_idx]),
        ('max_depth', np.full(len(rows), max_depth[modes].min()
                              if len(modes) else np.nan)),
        ('mix_frac', np.array([r[1] for r in rows], dtype=float)),
        ('divergence_weight', np.array([r[2] for r in rows], dtype=float)),
    ])
    return grid, read_depth, minor_modes


def _check_depth_coverage(experiment, max_depth, min_coverage=0.75):
    """Refuse configurations where too much of the genome exceeds the
    modellable depth."""
    depth = experiment.x[:, 2] / experiment.l
    covered = (
        ((depth <= max_depth) * experiment.l).sum() / experiment.l.sum())
    if covered < min_coverage:
        raise ValueError(
            'Unable to model {} of the genome, consider reducing max ploidy '
            'or increasing max copy number'.format(1. - covered))


def init_tables(experiment, config):
    """The restart grid and the depth diagnostics of the init store.

    Returns ({init_id: params dict with ``INIT_COLUMNS``},
    {'read_depth': Table, 'minor_modes': Series}).
    """
    grid, read_depth, minor_modes = enumerate_restarts(experiment, config)
    if len(grid) == 0:
        raise ValueError('the restart grid is empty: no candidate haploid '
                         'depths')
    _check_depth_coverage(experiment, grid['max_depth'][0])
    init_params = {
        init_id: {c: grid[c][init_id].item() for c in INIT_COLUMNS}
        for init_id in range(len(grid))}
    tables = {'read_depth': read_depth,
              'minor_modes': Series(minor_modes)}
    return init_params, tables


def init(init_results_filename, experiment_filename, config):
    """Enumerate the restart grid of the pickled experiment and write its
    depth diagnostics to the store ``init_results_filename``.

    Returns {init_id: params dict} with keys mode_idx, h_normal, h_tumour,
    mix_frac, divergence_weight, max_depth.
    """
    init_params, tables = init_tables(_load_pickle(experiment_filename),
                                      config)
    write_store(init_results_filename, tables)
    return init_params


def fit_task(results_filename, experiment_filename, init_params, config,
             device=None):
    """One-restart fit job: fits the pickled
    :class:`~remixt_tpu_torch.analysis.experiment.Experiment` and pickles
    its results. A snapshot is written next to the results after every EM
    iteration, a killed job resumes from it, and it is removed once the
    results are on disk."""
    experiment = _load_pickle(experiment_filename)
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


def cohort_devices(devices=None):
    """The devices of a cohort fit: ``None`` means every local CUDA
    device, ``cuda:0`` to ``cuda:{n-1}``, and raises without one."""
    import torch
    if devices is None:
        resolve_device('cuda')
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError('a cohort fit needs at least one device')
    return devices


def fit_many_cohort(experiments, init_params_dicts, config, devices=None):
    """Fit every sample's restart grid, each sample's with its own
    ``sample_specific`` config through ``fit_many`` on one device.

    This process takes its share of the samples
    (``parallel.distributed.cohort_partition``). With one sample, one
    device, ``use_cohort_sharding`` false or the grid not batched
    (``batch_restarts`` false, or ``optimal_initialization``) they are
    fitted one after another on the first device. Otherwise they are dealt
    to the devices in that order, and one worker thread per device fits
    its samples one after another on it, so no two fits share a device.

    Args:
        experiments: {sample_id: Experiment}
        init_params_dicts: {sample_id: {init_id: params dict}}
        config: config dict overlaying :mod:`remixt_tpu_torch.defaults`
        devices: torch devices; ``None`` means every local CUDA device

    Returns {sample_id: {init_id: fit_results}} for this process's share,
    in its order.
    """
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from remixt_tpu_torch.parallel import distributed

    get = lambda name: remixt_tpu_torch.config.get_param(config, name)
    sample_ids = distributed.cohort_partition(list(experiments))
    devices = cohort_devices(devices)

    def fit_samples(share, device):
        context = (torch.cuda.device(device) if device.type == 'cuda'
                   else contextlib.nullcontext())
        with context:
            return {sid: fit_many(
                experiments[sid], init_params_dicts[sid],
                remixt_tpu_torch.config.get_sample_config(config, sid),
                device=device) for sid in share}

    batched = get('batch_restarts') and not config.get(
        'optimal_initialization', False)
    if len(sample_ids) <= 1 or len(devices) <= 1 or not batched or \
            not get('use_cohort_sharding'):
        return fit_samples(sample_ids, devices[0])

    workers = min(len(devices), len(sample_ids))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(fit_samples, sample_ids[i::workers],
                               devices[i]) for i in range(workers)]
        fitted = {}
        for future in futures:
            fitted.update(future.result())
    return {sid: fitted[sid] for sid in sample_ids}


def build_model(experiment, init_params, config, device=None):
    """Construct the BreakpointModel for a restart's configuration."""
    get = lambda name: remixt_tpu_torch.config.get_param(config, name)
    device = resolve_device(device)
    dtype = resolve_dtype(get('engine_dtype'))

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
            'simulation (simulations.genome.Experiment, with genome_mixture '
            'and h)')
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


def store_fit_results(tables, experiment, fit_results, key_prefix):
    """Put one solution's tables (``cn``, ``brk_cn``, ``h``, ``mix``)
    under ``key_prefix`` in ``tables``, a dict or a store."""
    h = fit_results['h']
    cn_table = experiment_tables.create_cn_table(
        experiment, fit_results['cn'], h)
    cn_table['prob_is_outlier_total'] = fit_results['p_outlier_total'][:, 1]
    cn_table['prob_is_outlier_allele'] = fit_results['p_outlier_allele'][:, 1]
    cn_table['total_likelihood_mask'] = fit_results['total_likelihood_mask']
    cn_table['allele_likelihood_mask'] = fit_results['allele_likelihood_mask']

    tables[key_prefix + '/cn'] = cn_table
    tables[key_prefix + '/brk_cn'] = experiment_tables.create_brk_cn_table(
        fit_results['brk_cn'], experiment.breakpoint_segment_data)
    tables[key_prefix + '/h'] = Series(h)
    tables[key_prefix + '/mix'] = Series(h / h.sum())


def optimal_init_id(stats, config):
    """The chosen restart: the first largest ELBO among restarts whose
    proportion divergent is under ``max_prop_diverge``, or among all
    restarts when none is."""
    max_prop_diverge = remixt_tpu_torch.config.get_param(
        config, 'max_prop_diverge')
    candidates = np.flatnonzero(stats['proportion_divergent']
                                < max_prop_diverge)
    if len(candidates) == 0:
        candidates = np.arange(len(stats))
    best = candidates[np.nanargmax(stats['elbo'][candidates])]
    return stats['init_id'][best]


def store_optimal_solution(stats, tables, config):
    """Alias the chosen solution's ``cn``, ``mix`` and ``brk_cn`` at the
    top of ``tables``."""
    best = optimal_init_id(stats, config)
    for name in ('cn', 'mix', 'brk_cn'):
        tables[name] = tables['solutions/solution_{}/{}'.format(best, name)]


def collate_tables(experiment, fit_results_by_id, init_tables, config):
    """The results store's tables: ``stats`` (one row per restart, its
    ``init_id`` last), the init store's tables ``init_tables``, each
    solution's tables and the chosen solution's.

    Returns {key: Table or Series}.
    """
    stats = Table.from_records([
        dict(results['stats'], init_id=init_id)
        for init_id, results in fit_results_by_id.items()])
    tables = {'stats': stats}
    tables.update(init_tables)
    for init_id, results in fit_results_by_id.items():
        store_fit_results(tables, experiment, results,
                          'solutions/solution_{}'.format(init_id))
    store_optimal_solution(stats, tables, config)
    return tables


def collate(collate_filename, experiment_filename, init_results_filename,
            fit_results_filenames, config):
    """Merge the pickled per-restart results and the init store into the
    results store ``collate_filename``."""
    fit_results_by_id = {
        init_id: _load_pickle(filename)
        for init_id, filename in fit_results_filenames.items()}
    write_store(collate_filename, collate_tables(
        _load_pickle(experiment_filename), fit_results_by_id,
        read_store(init_results_filename), config))
