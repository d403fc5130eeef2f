"""The sample a fit reads, and its output tables (numpy).

Counterpart of ``remixt_tpu/analysis/experiment.py`` without pandas: map
each predicted breakend to the closest segment extremity of matching
chromosome and strand (within ``max_brk_dist`` summed over both ends),
derive wild-type adjacencies (same-chromosome neighbours with a gap of at
most ``max_seg_gap``), drop events that mimic a wild-type adjacency or
loop back onto one extremity, and expose the count matrix ``x``, lengths
``l``, adjacencies, chains and breakpoints the fit consumes; plus the
segment, copy-number and breakpoint copy-number tables of the results.

Tables are :class:`~remixt_tpu_torch.io.table.Table` objects with the
JAX package's columns, column order, dtypes and index.
"""

import pickle

import numpy as np

from remixt_tpu_torch.io.table import Table, inner_join, read_tsv
from remixt_tpu_torch.segalg import composite_keys

BREAKPOINT_COLUMNS = [
    'prediction_id',
    'chromosome_1', 'strand_1', 'position_1',
    'chromosome_2', 'strand_2', 'position_2',
]
BREAKPOINT_SEGMENT_COLUMNS = ['prediction_id', 'n_1', 'side_1', 'n_2',
                              'side_2']


def _empty_table(columns):
    return Table([(c, np.array([], dtype=object)) for c in columns])


def match_breakends_to_extremities(segment_data, breakpoint_data):
    """Nearest same-chromosome, same-strand segment extremity of every
    predicted breakend.

    Each segment contributes two extremities: its start (strand '-',
    segment_side 0) and its end (strand '+', segment_side 1). Extremities
    and breakends are keyed ``(chromosome, strand) << 42 | position``, so
    one ``searchsorted`` against the sorted extremity keys resolves every
    breakend.

    Returns a Table with one row per matched breakend: ``prediction_id``,
    ``prediction_side`` (0/1), ``segment_idx``, ``segment_side`` and the
    absolute ``dist``; breakends with no extremity of their chromosome and
    strand are omitted.
    """
    columns = ['prediction_id', 'prediction_side', 'segment_idx',
               'segment_side', 'dist']
    n_seg, n_bp = len(segment_data), len(breakpoint_data)
    if n_seg == 0 or n_bp == 0:
        return _empty_table(columns)

    # one chromosome coding across segments and both breakend columns
    _, chrom_codes = np.unique(np.concatenate([
        segment_data['chromosome'].astype(str),
        breakpoint_data['chromosome_1'].astype(str),
        breakpoint_data['chromosome_2'].astype(str),
    ]), return_inverse=True)
    seg_chrom = chrom_codes[:n_seg]
    be_chrom = np.concatenate([chrom_codes[n_seg:n_seg + n_bp],
                               chrom_codes[n_seg + n_bp:]])

    # extremities: [all starts (side 0); all ends (side 1)]
    ext_pos = np.concatenate([segment_data['start'],
                              segment_data['end']]).astype(np.int64)
    ext_side = np.repeat(np.array([0, 1]), n_seg)
    ext_seg = np.tile(np.arange(n_seg), 2)
    # bucket = chromosome * 2 + strand, where strand '+' <=> side 1
    ext_bucket = np.tile(seg_chrom, 2) * 2 + ext_side
    ext_keys = composite_keys(ext_bucket, ext_pos)
    order = np.argsort(ext_keys, kind='stable')
    sorted_keys = ext_keys[order]

    # breakends, two rows per prediction
    be_pos = np.concatenate([breakpoint_data['position_1'],
                             breakpoint_data['position_2']]).astype(np.int64)
    be_strand = np.concatenate([breakpoint_data['strand_1'] == '+',
                                breakpoint_data['strand_2'] == '+'])
    be_bucket = be_chrom * 2 + be_strand.astype(np.int64)
    be_keys = composite_keys(be_bucket, be_pos)

    # nearest sorted extremity: candidates at the insertion point and one
    # before it; a candidate counts only if it shares the bucket
    insert = np.searchsorted(sorted_keys, be_keys)
    best_idx = np.full(len(be_keys), -1)
    best_dist = np.full(len(be_keys), np.iinfo(np.int64).max, dtype=np.int64)
    for cand in (np.clip(insert - 1, 0, len(order) - 1),
                 np.clip(insert, 0, len(order) - 1)):
        flat = order[cand]
        dist = np.abs(ext_pos[flat] - be_pos)
        better = (ext_bucket[flat] == be_bucket) & (dist < best_dist)
        best_idx = np.where(better, flat, best_idx)
        best_dist = np.where(better, dist, best_dist)

    matched = best_idx >= 0
    return Table([
        ('prediction_id',
         np.tile(breakpoint_data['prediction_id'], 2)[matched]),
        ('prediction_side', np.repeat(np.array([0, 1]), n_bp)[matched]),
        ('segment_idx', ext_seg[best_idx[matched]]),
        ('segment_side', ext_side[best_idx[matched]]),
        ('dist', best_dist[matched]),
    ])


def get_wild_type_adjacencies(segment_data, max_seg_gap):
    """Set of (idx, idx+1) pairs of same-chromosome neighbours whose gap is
    at most ``max_seg_gap``."""
    chrom = segment_data['chromosome']
    gap = segment_data['start'][1:] - segment_data['end'][:-1]
    adjacent = (chrom[1:] == chrom[:-1]) & (gap <= max_seg_gap)
    return set((int(i), int(i) + 1) for i in np.flatnonzero(adjacent))


def _encode_pairs(a, b, base):
    return np.asarray(a, dtype=np.int64) * base + np.asarray(b, dtype=np.int64)


def create_breakpoint_segment_table(segment_data, breakpoint_data, adjacencies,
                                    max_brk_dist=2000):
    """Resolve breakpoint predictions to segment-extremity pairs.

    Keeps predictions whose two breakends both matched extremities with a
    total distance of at most ``max_brk_dist``, sorted by
    ``prediction_id`` (pandas' ``pivot(...).dropna()``); drops events that
    mimic a wild-type adjacency and loop-backs onto a single extremity.
    """
    matched = match_breakends_to_extremities(segment_data, breakpoint_data)
    if len(matched) == 0:
        return _empty_table(BREAKPOINT_SEGMENT_COLUMNS)

    # wide layout: one row per prediction, both ends resolved
    ids, row = np.unique(matched['prediction_id'], return_inverse=True)
    side = matched['prediction_side']
    found = np.zeros((len(ids), 2), dtype=bool)
    n = np.zeros((len(ids), 2), dtype=np.int64)
    seg_side = np.zeros((len(ids), 2), dtype=np.int64)
    dist = np.zeros((len(ids), 2), dtype=np.int64)
    found[row, side] = True
    n[row, side] = matched['segment_idx']
    seg_side[row, side] = matched['segment_side']
    dist[row, side] = matched['dist']
    both = found.all(axis=1)
    if not both.any():
        return _empty_table(BREAKPOINT_SEGMENT_COLUMNS)
    ids, n, seg_side, dist = ids[both], n[both], seg_side[both], dist[both]

    keep = dist.sum(axis=1) <= max_brk_dist

    # events indistinguishable from a wild-type junction
    n_base = np.int64(len(segment_data) + 1)
    adj_codes = np.sort(np.fromiter(
        (_encode_pairs(a, b, n_base) for a, b in adjacencies),
        dtype=np.int64, count=len(adjacencies)))
    fwd = _encode_pairs(n[:, 0], n[:, 1], n_base)
    rev = _encode_pairs(n[:, 1], n[:, 0], n_base)
    keep &= ~(np.isin(fwd, adj_codes)
              & (seg_side[:, 0] == 1) & (seg_side[:, 1] == 0))
    keep &= ~(np.isin(rev, adj_codes)
              & (seg_side[:, 1] == 1) & (seg_side[:, 0] == 0))

    # loop-back onto one extremity is unsupported
    keep &= ~((n[:, 0] == n[:, 1]) & (seg_side[:, 0] == seg_side[:, 1]))

    return Table([
        ('prediction_id', ids[keep]),
        ('n_1', n[keep, 0]),
        ('side_1', seg_side[keep, 0]),
        ('n_2', n[keep, 1]),
        ('side_2', seg_side[keep, 1]),
    ])


def convert_breakpoints_to_dict(breakpoint_segment_data):
    """{prediction_id: frozenset((n, side), (n, side))} view of the table."""
    return {
        pid: frozenset([(n1, s1), (n2, s2)])
        for pid, n1, s1, n2, s2 in zip(
            breakpoint_segment_data['prediction_id'],
            breakpoint_segment_data['n_1'],
            breakpoint_segment_data['side_1'],
            breakpoint_segment_data['n_2'],
            breakpoint_segment_data['side_2'])
    }


class Experiment:
    """Read counts, segment lengths and the breakpoint graph of one sample.

    Built from arrays here, or from count and breakpoint tables by
    :meth:`from_tables`, which also keeps the segment coordinates that the
    restart grid (``analysis/readdepth.py``) and the results tables need.

    Args:
        x: (N, 3) major, minor and total read counts per segment
        l: (N,) segment lengths
        adjacencies: set of (n, n+1) wild-type adjacent segment pairs
        breakpoints: {breakpoint id: frozenset of two (segment, side)};
            None for an experiment made by :meth:`from_tables`
        segment_chromosome_id: (N,) chromosome name per segment
    """

    def __init__(self, x, l, adjacencies, breakpoints,
                 segment_chromosome_id=None):
        self.x = np.asarray(x)
        self.l = np.asarray(l)
        if self.x.ndim != 2 or self.x.shape[1] != 3:
            raise ValueError('x must be (N, 3)')
        if self.l.shape != (self.x.shape[0],):
            raise ValueError('l must be (N,)')
        self.adjacencies = set(adjacencies)
        self._breakpoints = None if breakpoints is None else dict(breakpoints)
        if segment_chromosome_id is None:
            segment_chromosome_id = np.full(self.x.shape[0], '1')
        self.segment_chromosome_id = np.asarray(segment_chromosome_id)
        # set by from_tables only
        self.segment_start = None
        self.segment_end = None
        self.segment_major_is_allele_a = None
        self.count_table = None
        self.breakpoint_segment_data = None

    @classmethod
    def from_tables(cls, count_table, breakpoint_table=None,
                    max_brk_dist=2000, max_seg_gap=int(3e6)):
        """An experiment from a count table (chromosome, start, end, length,
        major_readcount, minor_readcount, readcount, and optionally
        major_is_allele_a) and a breakpoint prediction table
        (``BREAKPOINT_COLUMNS``). Breakpoints joining a chromosome that is
        not modelled are dropped first."""
        if breakpoint_table is None:
            breakpoint_table = _empty_table(BREAKPOINT_COLUMNS)
        breakpoint_table = breakpoint_table.select(BREAKPOINT_COLUMNS)

        # only predictions joining modelled chromosomes are resolvable
        modelled = set(count_table['chromosome'])
        on_modelled = np.array([
            c1 in modelled and c2 in modelled
            for c1, c2 in zip(breakpoint_table['chromosome_1'],
                              breakpoint_table['chromosome_2'])], dtype=bool)
        breakpoint_table = breakpoint_table.take(on_modelled)

        # the count table re-indexed 0..N-1, its positions as column 'index'
        count_table = Table([('index', np.arange(len(count_table)))]
                            + list(count_table.items()))
        adjacencies = get_wild_type_adjacencies(count_table, max_seg_gap)
        breakpoint_segment_data = inner_join(
            create_breakpoint_segment_table(
                count_table, breakpoint_table, adjacencies,
                max_brk_dist=max_brk_dist),
            breakpoint_table, on='prediction_id')

        x = np.stack([count_table[c] for c in (
            'major_readcount', 'minor_readcount', 'readcount')], axis=1)
        experiment = cls(x, count_table['length'], adjacencies, None,
                         count_table['chromosome'])
        experiment.segment_start = count_table['start']
        experiment.segment_end = count_table['end']
        if 'major_is_allele_a' in count_table:
            experiment.segment_major_is_allele_a = \
                count_table['major_is_allele_a']
        experiment.count_table = count_table
        experiment.breakpoint_segment_data = breakpoint_segment_data
        return experiment

    @property
    def breakpoints(self):
        """{breakpoint id: frozenset of two (segment, side)}; of an
        experiment made from tables, built anew from the breakpoint segment
        table at every access, as the JAX package builds it. A frozenset's
        iteration order, which sets the slot order of a junction's
        breakends and so the model, changes with each pickle round trip
        where its two breakends share a hash slot; a fresh one has the JAX
        package's order."""
        if self._breakpoints is None:
            return convert_breakpoints_to_dict(self.breakpoint_segment_data)
        return self._breakpoints

    @property
    def chains(self):
        """(start, end) half-open runs of consecutively adjacent
        segments."""
        n = self.x.shape[0]
        cut_after = [idx + 1 for idx in range(n - 1)
                     if (idx, idx + 1) not in self.adjacencies]
        bounds = [0] + cut_after + [n]
        return list(zip(bounds[:-1], bounds[1:]))


def create_experiment(count_filename, breakpoint_filename, experiment_filename,
                      max_brk_dist=2000, min_length=None):
    """Read the count and breakpoint TSVs, keep segments longer than
    ``min_length``, build an :class:`Experiment` and pickle it."""
    count_table = read_tsv(count_filename, str_columns=('chromosome',))
    if min_length is not None:
        count_table = count_table.take(count_table['length'] > min_length)
    breakpoint_table = read_tsv(
        breakpoint_filename, str_columns=('chromosome_1', 'chromosome_2'))
    experiment = Experiment.from_tables(count_table, breakpoint_table,
                                        max_brk_dist=max_brk_dist)
    with open(experiment_filename, 'wb') as f:
        pickle.dump(experiment, f)


# ---------------------------------------------------------------------------
# output tables
# ---------------------------------------------------------------------------

def _need_coordinates(experiment):
    if experiment.segment_start is None:
        raise ValueError(
            'this needs the segment coordinates, which an Experiment built '
            'from arrays lacks; build it with Experiment.from_tables or '
            'create_experiment')


def create_segment_table(experiment):
    """Per-segment observation table with empirical depths."""
    _need_coordinates(experiment)
    x = experiment.x
    l = experiment.l
    with np.errstate(invalid='ignore', divide='ignore'):
        allele_ratio = np.nan_to_num(x[:, 1] / (x[:, 0] + x[:, 1]))
    table = Table([
        ('chromosome', experiment.segment_chromosome_id),
        ('start', experiment.segment_start),
        ('end', experiment.segment_end),
        ('length', l),
        ('major_readcount', x[:, 0]),
        ('minor_readcount', x[:, 1]),
        ('readcount', x[:, 2]),
        ('allele_ratio', allele_ratio),
        ('major_depth', x[:, 2] * (1. - allele_ratio) / l),
        ('minor_depth', x[:, 2] * allele_ratio / l),
        ('total_depth', x[:, 2] / l),
    ])
    if experiment.segment_major_is_allele_a is not None:
        table['major_is_allele_a'] = experiment.segment_major_is_allele_a
    return table


def create_cn_table(experiment, cn, h):
    """Inferred copy-number results table: per-clone calls, raw
    (depth-implied) copy numbers, and expected depths and counts under the
    model."""
    table = create_segment_table(experiment)

    M = cn.shape[1]
    for m in range(M):
        table['major_{}'.format(m)] = cn[:, m, 0]
        table['minor_{}'.format(m)] = cn[:, m, 1]

    h_tumour = h[1:].sum()
    for allele, name in ((0, 'major'), (1, 'minor')):
        depth_e = cn[:, :, allele] @ h
        table[name + '_raw'] = (
            table[name + '_depth'] - cn[:, 0, allele] * h[0]) / h_tumour
        table[name + '_depth_e'] = depth_e
        table[name + '_e'] = depth_e * experiment.l
        table[name + '_raw_e'] = (depth_e - cn[:, 0, allele] * h[0]) / h_tumour

    table['total_depth_e'] = cn.sum(axis=-1) @ h
    table['total_e'] = table['total_depth_e'] * experiment.l

    if M > 2:
        table['major_diff'] = np.abs(table['major_1'] - table['major_2'])
        table['minor_diff'] = np.abs(table['minor_1'] - table['minor_2'])
    return table


def create_brk_cn_table(brk_cn, breakpoint_segment_data):
    """Breakpoint copy-number results joined onto the prediction info: one
    row per entry of ``brk_cn``, in its order, with ``cn_0..cn_{M-1}`` and
    then the breakpoint's segment and prediction columns. An empty
    ``brk_cn`` gives a table with a ``prediction_id`` column alone."""
    if len(brk_cn) == 0:
        return _empty_table(['prediction_id'])
    ids = list(brk_cn)
    cn = np.array([np.asarray(brk_cn[k]) for k in ids])
    table = Table([('prediction_id', np.asarray(ids))]
                  + [('cn_{}'.format(m), cn[:, m])
                     for m in range(cn.shape[1])])
    return inner_join(table, breakpoint_segment_data, on='prediction_id')
