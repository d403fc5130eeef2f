"""Genomic interval keys, containment and segment refinement (numpy).

Counterpart of ``composite_keys``, ``reindex_segments``, the containment
lookups and counts, ``vrange`` and ``interval_position_overlap`` of
``remixt_tpu/segalg.py``: the experiment's breakend matcher needs the keys,
the simulation's evaluation the common refinement of two segmentations,
the ``run`` path's segment and allele counts the containment lookups.
"""

import numpy as np

from remixt_tpu_torch.io.table import Table

_POS_BITS = 42  # genomic positions < 2^42 ~ 4.4e12


def composite_keys(codes, positions):
    """One sortable int64 key per (chromosome code, position) pair."""
    return (np.asarray(codes).astype(np.int64) << _POS_BITS) \
        + np.asarray(positions).astype(np.int64)


def _empty_reindex():
    return Table([('chromosome', np.array([], dtype=object))]
                 + [(c, np.array([], dtype=np.int64))
                    for c in ('start', 'end', 'idx_1', 'idx_2')])


def _factorize(values):
    """Codes of ``values`` in order of first appearance, and the distinct
    values in that order (``pd.factorize``)."""
    first = {}
    codes = np.array([first.setdefault(v, len(first)) for v in values],
                     dtype=np.int64)
    return codes, np.array(list(first), dtype=object)


def reindex_segments(cn_1, cn_2):
    """Common refinement of two segment tables (:class:`Table` with
    chromosome, start and end columns).

    Returns a Table with columns chromosome/start/end/idx_1/idx_2: the
    refined sub-segments covered by BOTH inputs, with idx_* the covering
    rows' index labels. Vectorized over all chromosomes at once with
    composite (chromosome code, position) integer keys.
    """
    if len(cn_1) == 0 or len(cn_2) == 0:
        return _empty_reindex()

    codes, chrom_names = _factorize(
        [str(c) for c in cn_1['chromosome']]
        + [str(c) for c in cn_2['chromosome']])
    codes_1, codes_2 = codes[:len(cn_1)], codes[len(cn_1):]

    # refined boundaries: every start/end of either table, per chromosome
    bounds = np.unique(np.concatenate([
        composite_keys(codes_1, cn_1['start']),
        composite_keys(codes_1, cn_1['end']),
        composite_keys(codes_2, cn_2['start']),
        composite_keys(codes_2, cn_2['end']),
    ]))
    lo, hi = bounds[:-1], bounds[1:]
    same_chrom = (lo >> _POS_BITS) == (hi >> _POS_BITS)
    lo, hi = lo[same_chrom], hi[same_chrom]

    # a refined piece [lo, hi) is covered by a table row when one row's
    # composite-keyed [start, end) contains it
    def cover(codes_arr, table):
        start_keys = composite_keys(codes_arr, table['start'])
        end_keys = composite_keys(codes_arr, table['end'])
        order = np.argsort(start_keys, kind='stable')
        pos = np.searchsorted(start_keys[order], lo, side='right') - 1
        safe = np.maximum(pos, 0)
        hit = (pos >= 0) & (hi <= end_keys[order][safe]) & (
            lo >= start_keys[order][safe])
        return np.where(hit, order[safe], -1)

    cover_1 = cover(codes_1, cn_1)
    cover_2 = cover(codes_2, cn_2)
    both = (cover_1 >= 0) & (cover_2 >= 0)
    if not both.any():
        return _empty_reindex()

    lo, hi = lo[both], hi[both]
    mask = (np.int64(1) << _POS_BITS) - 1
    return Table([
        ('chromosome', chrom_names[lo >> _POS_BITS]),
        ('start', lo & mask),
        ('end', hi & mask),
        ('idx_1', cn_1.index[cover_1[both]]),
        ('idx_2', cn_2.index[cover_2[both]]),
    ])


def find_contained_positions(X, Y):
    """Index into non-overlapping start-sorted segments X of the segment
    containing each position in Y (half-open [start, end)); -1 where
    uncontained."""
    Y = np.asarray(Y)
    candidate = np.searchsorted(X[:, 0], Y, side='right') - 1
    safe = np.maximum(candidate, 0)
    hit = (candidate >= 0) & (Y < X[safe, 1])
    return np.where(hit, candidate, -1)


def find_contained_segments(X, Y):
    """Index into non-overlapping start-sorted X of the segment fully
    containing each Y segment; -1 where uncontained."""
    candidate = find_contained_positions(X, Y[:, 0])
    safe = np.maximum(candidate, 0)
    hit = (candidate >= 0) & (Y[:, 1] <= X[safe, 1])
    return np.where(hit, candidate, -1)


def contained_counts(X, Y):
    """Counts of Y segments fully contained in each of the non-overlapping
    start-sorted X segments."""
    owner = find_contained_segments(X, Y)
    return np.bincount(owner[owner >= 0], minlength=X.shape[0]).astype(float)


def overlapping_counts(X, Y):
    """For each sorted position X[i], the number of Y segments with
    Y[:, 0] < X[i] < Y[:, 1], via a difference array."""
    enter = np.searchsorted(X, Y[:, 0], side='right')
    leave = np.searchsorted(X, Y[:, 1], side='left')
    delta = np.bincount(enter, minlength=X.shape[0] + 1)
    delta = delta - np.bincount(leave, minlength=X.shape[0] + 1)
    return np.cumsum(delta[:-1]).astype(float)


def vrange(starts, lengths):
    """Concatenated integer ranges [s, s + length) for each pair."""
    starts = np.asarray(starts)
    lengths = np.asarray(lengths)
    offsets = np.arange(lengths.sum()) - np.repeat(
        np.concatenate(([0], np.cumsum(lengths)[:-1])), lengths)
    return np.repeat(starts, lengths) + offsets


def interval_position_overlap(intervals, positions):
    """Pairs (interval_idx, position_idx) for every sorted position falling
    inside each (possibly overlapping) interval."""
    first = np.searchsorted(positions, intervals[:, 0])
    last = np.searchsorted(positions, intervals[:, 1])
    spans = last - first
    return np.repeat(np.arange(len(spans)), spans), vrange(first, spans)
