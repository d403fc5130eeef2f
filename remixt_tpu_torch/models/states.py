"""Copy-number state-space enumeration.

Enumerates the HMM state space (clone × allele copy-number tuples) and the
breakpoint copy-number state space, with the same constraints and the same
deduplication-under-allele-swap representative selection as the reference
(remixt cn_model.py:228-276), so state indices and posteriors
line up one-to-one for parity checks.

All enumeration is host-side numpy producing static-shape int arrays; on
device the state tensors are consumed in a factored form (shared tumour-state
block + per-segment normal row) — see :mod:`remixt_tpu_torch.models.engine`.
"""

import itertools

import numpy as np


def enumerate_cn_states(num_clones, num_alleles, cn_max, cn_diff_max,
                        normal_cn=(1, 1)):
    """Enumerate allele-specific copy-number states for one segment.

    Constraints (cn_model.py:236-249): tumour-clone total copy number at most
    `cn_max`; per-allele difference between tumour clones at most
    `cn_diff_max`; states equivalent under swapping both alleles across all
    tumour clones are deduplicated. The surviving representative for each swap
    pair is the LAST tuple in lexicographic enumeration order, placed at the
    list position of the FIRST occurrence — matching the reference's
    dict-insert semantics exactly so state indices agree.

    Returns:
        ndarray of shape (S, num_clones, num_alleles), int64
    """
    num_tumour_vars = (num_clones - 1) * num_alleles

    cn_states = dict()
    for cn in itertools.product(range(cn_max + 1), repeat=num_tumour_vars):
        cn = np.concatenate([np.asarray(normal_cn), cn]).reshape((num_clones, num_alleles))

        if not np.all(cn[1:, :].sum(axis=1) <= cn_max):
            continue

        if not np.all(cn[1:, :].max(axis=0) - cn[1:, :].min(axis=0) <= cn_diff_max):
            continue

        cn_key = tuple(cn[1:, :].flatten())
        cn_swapped_key = tuple(cn[1:, ::-1].flatten())
        cn_states[frozenset([cn_key, cn_swapped_key])] = cn

    return np.array(list(cn_states.values()), dtype=np.int64)


def enumerate_brk_states(num_clones, cn_max, cn_diff_max):
    """Enumerate breakpoint copy-number states.

    Normal clone fixed at 0 copies of the breakpoint-spanning adjacency;
    tumour clones at most `cn_max` with inter-clone difference at most
    `cn_diff_max` (cn_model.py:255-276).

    Returns:
        ndarray of shape (num_brk_states, num_clones), int64
    """
    brk_states = []
    for cn in itertools.product(range(cn_max + 1), repeat=num_clones - 1):
        cn = np.array((0,) + cn, dtype=np.int64)

        if not np.all(cn <= cn_max):
            continue

        if cn.shape[0] > 1 and not (cn[1:].max() - cn[1:].min() <= cn_diff_max):
            continue

        brk_states.append(cn)

    return np.array(brk_states, dtype=np.int64)


def state_indicators(cn_states):
    """Per-state indicator planes used by the likelihood special cases.

    Args:
        cn_states: (..., S, num_clones, num_alleles) int array

    Returns dict with (bpmodel.pyx:504-507 semantics):
        total: (..., S, num_clones) per-clone total copy number
        num_alleles_subclonal: (..., S) count of alleles whose copy number
            differs between tumour clones
        is_hdel: (..., S) all clones, all alleles zero (homozygous deletion)
        is_loh: (..., S) some allele has zero total across clones
    """
    cn_states = np.asarray(cn_states)
    total = cn_states.sum(axis=-1)
    tumour = cn_states[..., 1:, :]
    num_alleles_subclonal = np.sum(
        tumour.max(axis=-2) != tumour.min(axis=-2), axis=-1).astype(np.int64)
    is_hdel = np.all(cn_states == 0, axis=(-2, -1)).astype(np.int64)
    is_loh = np.any(cn_states.sum(axis=-2) == 0, axis=-1).astype(np.int64)
    return dict(
        total=total,
        num_alleles_subclonal=num_alleles_subclonal,
        is_hdel=is_hdel,
        is_loh=is_loh,
    )
