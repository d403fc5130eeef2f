"""Genomic interval keys (numpy).

Counterpart of ``composite_keys`` of ``remixt_tpu/segalg.py``, the one
function of that module the experiment's breakend matcher needs.
"""

import numpy as np

_POS_BITS = 42  # genomic positions < 2^42 ~ 4.4e12


def composite_keys(codes, positions):
    """One sortable int64 key per (chromosome code, position) pair."""
    return (np.asarray(codes).astype(np.int64) << _POS_BITS) \
        + np.asarray(positions).astype(np.int64)
