"""Simulation tasks and the accuracy evaluation (numpy).

Counterpart of the count-level part of
``remixt_tpu/simulations/pipeline.py`` without pandas: simulation
definition parsing and expansion, the genome-mixture and experiment
simulation tasks, their summary and segment/breakpoint tables, and the
metrics the benchmark judges a fit by — length-weighted segment
copy-number accuracy (``proportion_cn_correct`` and friends), breakpoint
copy-number accuracy against the cycle-minimized truth, mixture-fraction
recovery and outlier-call accuracy — plus the per-store evaluation and
merge tasks.

Truth and prediction are aligned once on the segment overlap index
(``segalg.reindex_segments``) or on ``prediction_id``, and every metric is
a length-weighted reduction over that aligned table. ``evaluate_tables``
evaluates ``collate_tables``' results in memory; ``evaluate_results_task``
and ``merge_evaluations`` read and write stores: the JAX package's HDF5
layout, or without h5py a directory of TSV tables (``io/store.py``). The
read-level tasks (germline alleles, read simulation and resampling) and
the plots are not ported: a plot file name raises.
"""

import collections
import csv
import hashlib
import itertools
import pickle

import numpy as np

from remixt_tpu_torch import segalg
from remixt_tpu_torch.io import store
from remixt_tpu_torch.io.table import (
    NA_FIELDS, Series, Table, inner_join, left_join, write_tsv)
from remixt_tpu_torch.simulations import genome as sim_genome


def _load_pickle(filename):
    with open(filename, 'rb') as f:
        return pickle.load(f)


def _dump_pickle(obj, filename):
    with open(filename, 'wb') as f:
        pickle.dump(obj, f)


def _no_plot(plot_filename):
    if plot_filename is not None:
        raise NotImplementedError(
            'plots are not ported yet; pass None for the plot file '
            '(got {!r})'.format(plot_filename))


# ---------------------------------------------------------------------------
# simulation definitions
# ---------------------------------------------------------------------------

def _expand_setting_grid(settings):
    """Cartesian product over per-key value lists; a tuple key ties several
    parameters to vary together."""
    keys = list(settings.keys())
    combos = itertools.product(*(settings[k] for k in keys))
    for combo in combos:
        expanded = {}
        for key, value in zip(keys, combo):
            if isinstance(key, tuple):
                if len(key) != len(value):
                    raise ValueError(
                        'tied setting {} needs {} values'.format(key, len(key)))
                expanded.update(zip(key, value))
            else:
                expanded[key] = value
        yield expanded


def read_sim_defs(sim_defs_filename):
    """Parse a python-syntax simulation definition file into a dict of
    per-instance settings.

    Each ``<name>_settings`` dict in the file is a grid of value lists; the
    grid expands to instances overlaid on ``defaults``, each given a
    content-hashed ``sim_id``.
    """
    namespace = {}
    with open(sim_defs_filename) as f:
        exec(f.read(), {}, namespace)
    defaults = namespace['defaults']

    instances = {}
    for name, settings in namespace.items():
        if not name.endswith('_settings'):
            continue
        base_name = name[:-len('_settings')]
        for expanded in _expand_setting_grid(settings):
            sim = dict(defaults)
            sim.update(expanded)
            sim['name'] = base_name
            # a stable digest: Python's built-in hash() is salted per
            # process, which would re-key every output directory on rerun
            content = '\0'.join(sorted(
                '{}={}'.format(k, v) for k, v in sim.items()))
            content_hash = hashlib.sha1(
                content.encode('utf-8')).hexdigest()[:16]
            sim['sim_hash'] = content_hash
            sim['sim_id'] = '{}_{}'.format(base_name, content_hash)
            if sim['sim_id'] in instances:
                raise ValueError('duplicate simulation {}'.format(sim['sim_id']))
            instances[sim['sim_id']] = sim
    return instances


def create_simulations(sim_defs_filename, config, ref_data_dir):
    """Expand a YAML simulation definition into per-instance parameter
    dicts.

    Each simulation block contributes ``num_simulations`` parameter sets
    (scalar values broadcast; list values must match) replicated
    ``num_replicates`` times with consecutive random seeds. Every
    simulation needs ``chromosome_lengths`` in the definition: reading
    them from reference data (``ref_data_dir``) is not ported yet.
    """
    import yaml

    with open(sim_defs_filename) as f:
        sim_defs = yaml.safe_load(f)

    instances = {}
    for sim_name, block in sim_defs['simulations'].items():
        num_sims = block['num_simulations']
        num_reps = block['num_replicates']

        # broadcast every setting to one value per simulation index
        per_sim = {}
        for key, value in block.items():
            if key == 'num_simulations':
                continue
            values = value if isinstance(value, (list, tuple)) else [value]
            if len(values) == 1:
                values = list(values) * num_sims
            if len(values) != num_sims:
                raise TypeError('sim config length mismatch for {}, {}'.format(
                    sim_name, key))
            per_sim[key] = values

        seed = block['random_seed_start']
        for sim_idx in range(num_sims):
            for rep_idx in range(num_reps):
                params = dict(sim_defs['defaults'])
                params.update(
                    {key: values[sim_idx] for key, values in per_sim.items()})
                params['random_seed'] = seed
                instances['{}_{}_{}'.format(sim_name, sim_idx, rep_idx)] = params
                seed += 1

    for params in instances.values():
        if 'chromosome_lengths' not in params:
            if ref_data_dir is None:
                raise ValueError(
                    'chromosome_lengths required in sim defs when no '
                    'ref_data_dir is provided')
            raise NotImplementedError(
                'chromosome lengths from reference data are not ported yet; '
                'give chromosome_lengths in the sim defs')
        params.setdefault(
            'chromosomes', list(params['chromosome_lengths'].keys()))

    return instances


# ---------------------------------------------------------------------------
# simulation tasks
# ---------------------------------------------------------------------------

def sample_genome_mixture(params, rng=None):
    """A genome collection and mixture drawn from ``rng``, by default
    ``RandomState(params['random_seed'])``."""
    if rng is None:
        rng = np.random.RandomState(params['random_seed'])
    collection_sampler = sim_genome.GenomeCollectionSampler(
        sim_genome.RearrangementHistorySampler(params), params)
    return sim_genome.GenomeMixtureSampler(params).sample_genome_mixture(
        collection_sampler.sample_genome_collection(rng), rng)


def sample_experiment(params):
    """A count-level experiment drawn from
    ``RandomState(params['random_seed'])``: the JAX package's
    ``simulate_experiment`` draws the same one from numpy's global
    generator seeded alike."""
    rng = np.random.RandomState(params['random_seed'])
    mixture = sample_genome_mixture(params, rng)
    return sim_genome.ExperimentSampler(params).sample_experiment(mixture, rng)


def simulate_genome_mixture(mixture_filename, mixture_plot_filename, params):
    """Sample a genome collection + mixture and pickle it."""
    _no_plot(mixture_plot_filename)
    _dump_pickle(sample_genome_mixture(params), mixture_filename)


def simulate_experiment(experiment_filename, experiment_plot_filename, params):
    """Sample a full count-level experiment and pickle it."""
    _no_plot(experiment_plot_filename)
    _dump_pickle(sample_experiment(params), experiment_filename)


def tabulate_experiment(exp_table_filename, sim_id, experiment_filename):
    """One-row composition summary of a simulated experiment."""
    experiment = _load_pickle(experiment_filename)
    collection = experiment.genome_mixture.genome_collection

    row = {
        'sim_id': sim_id,
        'proportion_divergent': (
            collection.length_divergent()
            / float(np.sum(experiment.genome_mixture.l))),
    }
    for idx, genome in enumerate(collection.genomes):
        row['proportion_loh_{}'.format(idx)] = genome.proportion_loh()
        row['proportion_hdel_{}'.format(idx)] = genome.proportion_hdel()
        row['proportion_hlamp_{}'.format(idx)] = genome.proportion_hlamp()

    write_tsv(Table.from_records([row]), exp_table_filename)


def merge_tables(output_filename, input_filenames):
    """Concatenate TSVs ({key: filename}) as text: columns in the order
    they first appear, pandas' missing-value markers and absent columns
    written empty."""
    header, rows = [], []
    for filename in input_filenames.values():
        with open(filename, newline='') as f:
            lines = [line for line in csv.reader(f, delimiter='\t') if line]
        if not lines:
            continue
        header += [name for name in lines[0] if name not in header]
        rows += [dict(zip(lines[0], line)) for line in lines[1:]]
    with open(output_filename, 'w', newline='') as f:
        out = csv.writer(f, delimiter='\t', lineterminator='\n')
        out.writerow(header)
        for row in rows:
            out.writerow(['' if row.get(name, '') in NA_FIELDS
                          else row[name] for name in header])


def _segment_table(collection):
    return Table([
        ('chromosome', collection.segment_chromosome_id),
        ('start', collection.segment_start),
        ('end', collection.segment_end),
    ])


def write_segments(segment_filename, genomes_filename):
    """The simulated segments (chromosome, start, end) as a TSV."""
    write_tsv(_segment_table(_load_pickle(genomes_filename)),
              segment_filename)


def write_perfect_segments(segment_filename, genomes_filename):
    """Segments merged between true copy-number changepoints, as a TSV
    sorted by chromosome name and run."""
    collection = _load_pickle(genomes_filename)

    cn_changes = np.abs(np.diff(collection.cn, axis=0)).sum(axis=(1, 2)) > 0
    run_id = np.concatenate(([0], np.cumsum(cn_changes)))

    chromosome = np.asarray(collection.segment_chromosome_id, dtype=str)
    groups = {}
    for key, start, end in zip(zip(chromosome.tolist(), run_id.tolist()),
                               collection.segment_start,
                               collection.segment_end):
        first = groups.setdefault(key, [start, end])
        first[0], first[1] = min(first[0], start), max(first[1], end)
    keys = sorted(groups)
    write_tsv(Table([
        ('chromosome', np.array([k[0] for k in keys], dtype=object)),
        ('start', np.array([groups[k][0] for k in keys])),
        ('end', np.array([groups[k][1] for k in keys])),
    ]), segment_filename)


def write_breakpoints(breakpoint_filename, mixture_filename):
    """The detected breakpoints' segment table as a TSV."""
    write_tsv(_load_pickle(mixture_filename).breakpoint_segment_data,
              breakpoint_filename)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _weighted_fraction(mask, weights):
    return float((mask * weights).sum()) / float(weights.sum())


def _aligned_cn_arrays(genome_mixture, cn_data_table, order_true, order_pred):
    """Align true and predicted per-clone copy-number arrays on the overlap
    of the true and predicted segmentations.

    Returns (cn_true, cn_pred, overlap_lengths) with clone axes ordered by
    decreasing mixture fraction and allele axes sorted so major >= minor.
    """
    # (N, clones, alleles) truth and prediction in matching layouts
    if 'major_1' in cn_data_table:
        cn_true = genome_mixture.cn[:, 1:, :]
        cn_pred = np.stack([
            np.stack([cn_data_table['major_1'],
                      cn_data_table['minor_1']], axis=1),
            np.stack([cn_data_table['major_2'],
                      cn_data_table['minor_2']], axis=1),
        ], axis=1)
    else:
        # total-only callers: compare clone totals with a singleton allele axis
        cn_true = genome_mixture.cn[:, 1:, :].sum(axis=2, keepdims=True)
        cn_pred = np.stack([
            cn_data_table['total_1'][:, None],
            cn_data_table['total_2'][:, None],
        ], axis=1)

    cn_true = np.sort(cn_true[:, order_true, :], axis=2)[:, :, ::-1]
    cn_pred = np.sort(cn_pred[:, order_pred, :], axis=2)[:, :, ::-1]

    overlap = segalg.reindex_segments(_segment_table(genome_mixture),
                                      cn_data_table)

    return (
        cn_true[overlap['idx_1']],
        cn_pred[overlap['idx_2']],
        overlap['end'] - overlap['start'],
    )


def evaluate_cn_results(genome_mixture, cn_data_table, order_true, order_pred,
                        allow_swap):
    """Length-weighted segment copy-number accuracy metrics."""
    cn_true, cn_pred, lengths = _aligned_cn_arrays(
        genome_mixture, cn_data_table, order_true, order_pred)

    metrics = {}

    if cn_true.shape[1] != cn_pred.shape[1]:
        metrics['proportion_cn_correct'] = -1.
    else:
        exact = (cn_true == cn_pred).all(axis=(1, 2))
        if allow_swap:
            exact |= (cn_true == cn_pred[:, ::-1, :]).all(axis=(1, 2))
        metrics['proportion_cn_correct'] = _weighted_fraction(exact, lengths)

    metrics['proportion_dom_cn_correct'] = _weighted_fraction(
        (cn_true[:, 0, :] == cn_pred[:, 0, :]).all(axis=1), lengths)

    # clonality: does every clone share the dominant clone's copy number
    clonal_true = (cn_true == cn_true[:, :1, :]).all(axis=(1, 2))
    clonal_pred = (cn_pred == cn_pred[:, :1, :]).all(axis=(1, 2))
    metrics['proportion_clonal_correct'] = _weighted_fraction(
        clonal_true == clonal_pred, lengths)
    metrics['proportion_subclonal_correct'] = _weighted_fraction(
        ~clonal_true == ~clonal_pred, lengths)

    # length-weighted ploidies: clone-averaged and per-clone
    for label, cn in (('pred', cn_pred), ('true', cn_true)):
        metrics['{}_ploidy'.format(label)] = _weighted_fraction(
            cn.mean(axis=1).sum(axis=1), lengths)
        for clone in (0, 1):
            metrics['{}_ploidy_{}'.format(label, clone + 1)] = (
                _weighted_fraction(cn[:, clone, :].sum(axis=1), lengths))
        divergent = (cn.max(axis=1) != cn.min(axis=1)).sum(axis=1)
        metrics['{}_proportion_divergent'.format(label)] = (
            _weighted_fraction(divergent, lengths) / 2.)

    return {'cn_evaluation': Series.from_dict(metrics)}


def _true_breakpoint_table(genome_mixture):
    """Per-prediction truth columns: raw and minimized true copy numbers
    plus balancedness, aligned on prediction_id."""
    collection = genome_mixture.genome_collection
    true_cn = collection.collapsed_breakpoint_copy_number()
    min_cn = collection.collapsed_minimal_breakpoint_copy_number()
    balanced = collection.collapsed_balanced_breakpoints()

    M = genome_mixture.M
    zeros = np.zeros(M)
    rows = []
    for prediction_id, bp in genome_mixture.detected_breakpoints.items():
        raw = true_cn.get(bp, zeros)
        minimal = min_cn.get(bp, zeros)
        row = {'prediction_id': prediction_id, 'is_balanced': bp in balanced}
        for m in range(1, M):
            row['true_cn_{}'.format(m)] = raw[m]
            row['min_true_cn_{}'.format(m)] = minimal[m]
        rows.append(row)
    return Table.from_records(rows)


def _columns(table, names):
    """(rows, len(names)) array of the named columns."""
    return np.stack([table[name] for name in names], axis=1)


def evaluate_brk_cn_results(genome_mixture, brk_cn_table, order_true,
                            order_pred, allow_swap):
    """Breakpoint copy-number accuracy against the cycle-minimized truth,
    excluding balanced breakpoints."""
    min_true_cols = ['min_true_cn_{}'.format(m)
                     for m in range(1, genome_mixture.M)]
    pred_cols = []
    for m in itertools.count(1):
        col = 'cn_{}'.format(m)
        if col not in brk_cn_table:
            break
        pred_cols.append(col)

    data = inner_join(genome_mixture.breakpoint_segment_data,
                      _true_breakpoint_table(genome_mixture),
                      on='prediction_id')
    data = left_join(data, brk_cn_table.select(['prediction_id'] + pred_cols),
                     on='prediction_id', fill_value=0.0)
    data = data.take(~data['is_balanced'].astype(bool))

    cn_true = _columns(data, min_true_cols)[:, order_true]
    cn_pred = _columns(data, pred_cols)[:, order_pred]

    if cn_true.shape[1] != cn_pred.shape[1]:
        correct = np.full(len(data), -1.)
    else:
        correct = (cn_true == cn_pred).all(axis=1)
        if allow_swap:
            correct |= (cn_true == cn_pred[:, ::-1]).all(axis=1)

    true_present = (_columns(data, min_true_cols) > 0).any(axis=1)
    pred_present = (_columns(data, pred_cols) > 0).any(axis=1)
    data['cn_correct'] = correct
    data['true_present'] = true_present
    data['pred_present'] = pred_present
    data['true_subclonal'] = (
        (_columns(data, min_true_cols) == 0).any(axis=1) & true_present)
    data['pred_subclonal'] = (
        (_columns(data, pred_cols) == 0).any(axis=1) & pred_present)

    metrics = {
        'brk_cn_correct_proportion': (
            float(data['cn_correct'].sum()) / float(len(data))),
        'brk_cn_present_num_true': float(data['true_present'].sum()),
        'brk_cn_present_num_pos': float(data['pred_present'].sum()),
        'brk_cn_present_num_true_pos': float(
            (data['pred_present'] & data['true_present']).sum()),
        'brk_cn_subclonal_num_true': float(data['true_subclonal'].sum()),
        'brk_cn_subclonal_num_pos': float(data['pred_subclonal'].sum()),
        'brk_cn_subclonal_num_true_pos': float(
            (data['pred_subclonal'] & data['true_subclonal']).sum()),
    }

    return {
        'brk_cn_table': data,
        'brk_cn_evaluation': Series.from_dict(metrics),
    }


def _copy(table):
    return Table(list(table.items()), index=table.index,
                 index_name=table.index_name)


def evaluate_results(genome_mixture, cn_table, brk_cn_table, mix_pred):
    """Full evaluation: order clones by mixture fraction, tolerate clone
    swaps for near-equal mixtures, pad single-clone callers to two
    clones."""
    if len(cn_table) == 0 or np.shape(mix_pred)[0] == 0:
        empty = Series(np.array([], dtype=float))
        return {
            'brk_cn_evaluation': empty,
            'brk_cn_table': Table(),
            'cn_evaluation': empty,
            'mix_results': empty}

    cn_table = _copy(cn_table)
    brk_cn_table = _copy(brk_cn_table)

    # single-tumour-clone callers evaluate as two identical clones
    for a, b in (('major_1', 'major_2'), ('minor_1', 'minor_2'),
                 ('total_1', 'total_2')):
        if a in cn_table and b not in cn_table:
            cn_table[b] = cn_table[a]
    if 'cn_2' not in brk_cn_table:
        brk_cn_table['cn_2'] = (brk_cn_table['cn_1'] if 'cn_1' in brk_cn_table
                                else np.full(len(brk_cn_table), np.nan))

    mix_true = np.asarray(genome_mixture.frac, dtype=float).copy()
    mix_pred = np.asarray(mix_pred, dtype=float).copy()
    if len(mix_pred) == 2:
        mix_pred = np.concatenate([mix_pred, [0.]])

    order_true = np.argsort(mix_true[1:])[::-1]
    order_pred = np.argsort(mix_pred[1:])[::-1]
    mix_true = np.concatenate([mix_true[:1], mix_true[1:][order_true]])
    mix_pred = np.concatenate([mix_pred[:1], mix_pred[1:][order_pred]])

    # near-equal tumour clones are inherently order-ambiguous
    allow_swap = mix_true[1:].min() / mix_true[1:].max() > 0.75

    results = evaluate_cn_results(
        genome_mixture, cn_table, order_true, order_pred, allow_swap)
    results.update(evaluate_brk_cn_results(
        genome_mixture, brk_cn_table, order_true, order_pred, allow_swap))

    results['mix_results'] = Series.from_dict(dict(
        [('mix_true_{}'.format(i), f) for i, f in enumerate(mix_true)]
        + [('mix_pred_{}'.format(i), f) for i, f in enumerate(mix_pred)]))

    return results


def evaluate_likelihood_results(experiment, cn_data_table):
    """Outlier-call accuracy against the simulated outlier indicators."""
    overlap = segalg.reindex_segments(
        _segment_table(experiment.genome_mixture), cn_data_table)
    lengths = overlap['end'] - overlap['start']

    metrics = {}
    for kind in ('total', 'allele'):
        truth = getattr(experiment, 'is_outlier_' + kind)[overlap['idx_1']]
        called = (cn_data_table['prob_is_outlier_' + kind] > 0.5)[
            overlap['idx_2']]
        metrics['correct_outlier_{}_proportion'.format(kind)] = (
            _weighted_fraction(truth == called, lengths))

    return {'outlier_evaluation': Series.from_dict(metrics)}


def evaluate_tables(experiment, tables, key_prefix=''):
    """Evaluate a results store's tables against the simulated truth.

    Args:
        experiment: a simulated
            :class:`~remixt_tpu_torch.simulations.genome.Experiment`, or a
            :class:`~remixt_tpu_torch.simulations.genome.GenomeMixture`
            (then without the outlier evaluation)
        tables: {key: Table or Series} as ``collate_tables`` returns them or
            ``io.store.read_store`` reads them
        key_prefix: where the evaluated solution's ``cn``, ``brk_cn`` and
            ``mix`` lie in ``tables``

    Returns {name: Table or Series}: ``cn_evaluation``, ``brk_cn_table``,
    ``brk_cn_evaluation``, ``mix_results`` and, for an experiment with
    outlier indicators, ``outlier_evaluation``.
    """
    def key(name):
        return (key_prefix + '/' + name).strip('/')

    cn_table = tables[key('cn')]
    brk_cn_table = tables.get(key('brk_cn'))
    if brk_cn_table is None:
        brk_cn_table = Table([(c, np.array([], dtype=object))
                              for c in ('prediction_id', 'cn_1', 'cn_2')])
    mix_pred = tables[key('mix')].values

    if isinstance(experiment, sim_genome.Experiment):
        mixture = experiment.genome_mixture
    else:
        mixture, experiment = experiment, None
    evaluation = evaluate_results(mixture, cn_table, brk_cn_table, mix_pred)
    if experiment is not None and hasattr(experiment, 'is_outlier_total'):
        evaluation.update(evaluate_likelihood_results(experiment, cn_table))
    return evaluation


def evaluate_results_task(evaluation_filename, results_filename,
                          mixture_filename=None, experiment_filename=None,
                          key_prefix=''):
    """Evaluate one results store against simulation truth and write the
    evaluation store (each an HDF5 file or a directory of TSV tables,
    ``io/store.py``)."""
    tables = store.read_store(results_filename, keys=[
        (key_prefix + '/' + table).strip('/')
        for table in ('cn', 'brk_cn', 'mix')])

    if mixture_filename is not None:
        truth = _load_pickle(mixture_filename)
    elif experiment_filename is not None:
        truth = _load_pickle(experiment_filename)
    else:
        raise ValueError(
            'either mixture_filename or experiment_filename must be set')

    store.write_store(evaluation_filename,
                      evaluate_tables(truth, tables, key_prefix))


def _as_str(values):
    """A column as ``astype(str)`` writes it to the store: each value's
    ``str``, missing values (None, NaN) as 'nan'."""
    return np.array(['nan' if v is None else str(v) for v in values.tolist()],
                    dtype=object)


def merge_evaluations(merged_filename, sim_defs, evaluation_filenames,
                      key_names):
    """Merge per-simulation/tool evaluations into one store (an HDF5 file
    or a directory of TSV tables, ``io/store.py``)."""
    if any('sim_id' in params for params in sim_defs.values()):
        raise ValueError('sim_id is the key of the simulations, not a '
                         'parameter')
    simulations = Table.from_records(
        [dict(sim_id=sim_id, **params)
         for sim_id, params in sim_defs.items()])
    merged = {'simulations': Table(
        [(name, _as_str(values)) for name, values in simulations.items()])}

    gathered = collections.defaultdict(list)
    for key, evaluation_filename in evaluation_filenames.items():
        key = key if isinstance(key, tuple) else (key,)
        evaluation = store.read_store(evaluation_filename)
        for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results',
                     'outlier_evaluation'):
            if name not in evaluation:
                continue
            row = evaluation[name].to_dict()
            for value, col in zip(key, key_names):
                row[col] = value
            gathered[name].append(row)
        if 'brk_cn_table' in evaluation:
            merged['brk_cn_table/' + '/'.join(map(str, key))] = (
                evaluation['brk_cn_table'])

    for name, rows in gathered.items():
        merged[name] = Table.from_records(rows)
    store.write_store(merged_filename, merged)
