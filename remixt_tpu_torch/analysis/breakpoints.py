"""Fuzzy breakpoint matching between two prediction sets (numpy).

Counterpart of ``remixt_tpu/analysis/breakpoints.py`` on
:class:`~remixt_tpu_torch.io.table.Table`: breakends pair on (chromosome,
strand) within a positional window, and a pair of predictions matches when
both sides of each are paired, each exactly once.
"""

import numpy as np

from remixt_tpu_torch.io.table import Table, as_column

_MATCH_COLUMNS = ('prediction_id_1', 'prediction_id_2')


def create_breakends(bp):
    """Long-form breakends: one row per (prediction, side), side 0 rows
    first, with columns prediction_id, prediction_side (0/1), chromosome,
    strand, position."""
    n = len(bp)
    columns = [('prediction_id', np.concatenate([bp['prediction_id']] * 2)),
               ('prediction_side', np.repeat(np.arange(2), n))]
    for name in ('chromosome', 'strand', 'position'):
        columns.append((name, np.concatenate(
            [bp[name + '_1'], bp[name + '_2']])))
    return Table(columns)


def _empty_matches():
    return Table([(name, np.array([], dtype=object))
                  for name in _MATCH_COLUMNS])


def match_breakpoints(bp1, bp2, search_range=400):
    """Approximately equal breakpoints between two prediction sets.

    A pair matches when each of prediction 1's breakends has a same-
    (chromosome, strand) breakend of prediction 2 within ``search_range``,
    and the two pairings use distinct sides of both predictions.

    Returns a table with columns prediction_id_1, prediction_id_2, sorted
    by them (the JAX package's groupby order).
    """
    if len(bp1) == 0 or len(bp2) == 0:
        return _empty_matches()
    ends1, ends2 = create_breakends(bp1), create_breakends(bp2)

    by_site = {}
    for j, site in enumerate(zip(ends2['chromosome'].tolist(),
                                 ends2['strand'].tolist())):
        by_site.setdefault(site, []).append(j)

    pairings = {}
    for i, site in enumerate(zip(ends1['chromosome'].tolist(),
                                 ends1['strand'].tolist())):
        for j in by_site.get(site, ()):
            if abs(ends1['position'][i] - ends2['position'][j]) \
                    <= search_range:
                key = (ends1['prediction_id'][i], ends2['prediction_id'][j])
                pairings.setdefault(key, []).append(
                    (ends1['prediction_side'][i],
                     ends2['prediction_side'][j]))

    # a valid match pairs both sides of each prediction, each exactly once
    matched = sorted(
        key for key, sides in pairings.items()
        if len(sides) == 2 and len({s1 for s1, _ in sides}) == 2
        and len({s2 for _, s2 in sides}) == 2)
    if not matched:
        return _empty_matches()
    return Table([(name, as_column(np.array([key[k] for key in matched])))
                  for k, name in enumerate(_MATCH_COLUMNS)])
