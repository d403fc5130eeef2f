"""Segmentation remap: insert zero-length dummy segments at breakends.

The breakpoint factor graph allows only a single breakend interposed between
each pair of adjacent segments; where multiple breakends meet at one junction
(or a breakend abuts a telomere), zero-length dummy segments are inserted.
Capability parity with the reference's remap construction
(remixt cn_model.py:82-167), rebuilt here as slot-record
emission: each junction position appends its slots to flat per-field lists,
and the arrays are materialized once at the end.
"""

import collections

import numpy as np


def get_brkend_seg_orient(breakend):
    """Map a (segment, side) breakend to (left segment of junction, orientation).

    Reference: cn_model.py:14-22.
    """
    n, side = breakend
    if side == 1:
        n_left = n
        orient = +1
    elif side == 0:
        n_left = n - 1
        orient = -1
    else:
        raise ValueError('side must be 0 or 1')
    return n_left, orient


class SegmentRemap:
    """Remapped segmentation with per-junction breakend assignment.

    Attributes:
        N, N1: original and remapped segment counts
        seg_fwd_remap: (N,) index of each original segment in the remap
        seg_rev_remap: (N1,) original segment index for each remapped segment
        seg_is_original: (N1,) bool
        is_telomere: (N1,) 1 where the transition out of the segment is free
        breakpoint_idx: (N1,) breakpoint id whose breakend follows the
            segment, or -1
        breakpoint_orient: (N1,) breakend orientation
    """

    def __init__(self, N, adjacencies, breakpoints):
        """
        Args:
            N: number of original segments
            adjacencies: set of (n, n+1) wild-type adjacent segment pairs
            breakpoints: sequence of frozensets of (segment, side) breakend pairs
        """
        self.N = N
        breakpoints = list(breakpoints)
        self.num_breakpoints = len(breakpoints)

        # Breakends grouped by the junction they interrupt: junction n sits
        # between original segments n and n+1 (n = -1 is the genome start).
        # Stored as sets of (bp_idx, be_idx, orient) and iterated in set
        # order — the reference's exact per-junction assignment order
        # (cn_model.py:86-90), kept so slot layouts (and therefore fits at
        # small iteration budgets) are bit-reproducible against it.
        junction_breakends = collections.defaultdict(set)
        for bp_idx, breakpoint in enumerate(breakpoints):
            for be_idx, breakend in enumerate(breakpoint):
                n_left, orient = get_brkend_seg_orient(breakend)
                junction_breakends[n_left].add((bp_idx, be_idx, orient))

        # Emit slots of the new segmentation position by position.  The image
        # of original segment n is the first slot emitted at position n; each
        # breakend needs a slot of its own (the first rides on the original
        # segment's slot when one exists), and a breakend-bearing junction
        # that is not a wild-type adjacency gets a trailing zero-length slot
        # to carry the free telomere transition.
        origin = []      # original segment each slot maps back to
        telomere = []    # 1 where the slot's outgoing transition is free
        bp_of_slot = []  # breakpoint id following the slot, or -1
        orient_of_slot = []
        fwd = np.zeros(N, dtype=int)
        original_slots = []

        for n in range(-1, N):
            if n >= 0:
                fwd[n] = len(origin)
                original_slots.append(len(origin))

            breakends = junction_breakends.get(n, ())
            if n >= 0 and not breakends:
                origin.append(n)
                telomere.append(0 if (n, n + 1) in adjacencies else 1)
                bp_of_slot.append(-1)
                orient_of_slot.append(0)
                continue

            for bp_idx, _, orient in breakends:
                origin.append(n)
                telomere.append(0)
                bp_of_slot.append(bp_idx)
                orient_of_slot.append(orient)
            if breakends and (n, n + 1) not in adjacencies:
                origin.append(n)
                telomere.append(1)
                bp_of_slot.append(-1)
                orient_of_slot.append(0)

        self.N1 = len(origin)
        self.seg_fwd_remap = fwd
        self.seg_rev_remap = np.asarray(origin, dtype=int)
        self.seg_is_original = np.zeros(self.N1, dtype=bool)
        self.seg_is_original[original_slots] = True
        self.is_telomere = np.asarray(telomere, dtype=int)
        self.breakpoint_idx = np.asarray(bp_of_slot, dtype=int)
        self.breakpoint_orient = np.asarray(orient_of_slot, dtype=int)

        # Invariants kept from the reference (cn_model.py:160-161): breakend
        # slots are never telomeres, and every breakpoint placed both ends.
        assert not np.any((self.breakpoint_idx >= 0) & (self.is_telomere == 1))
        if self.num_breakpoints > 0:
            placed = np.bincount(self.breakpoint_idx[self.breakpoint_idx >= 0])
            assert np.all(placed == 2)

    def expand_data(self, x, l):
        """Scatter original per-segment data into the remapped segmentation;
        dummy segments get zeros (cn_model.py:163-167)."""
        x = np.asarray(x)
        l = np.asarray(l)
        x1 = np.zeros((self.N1,) + x.shape[1:], dtype=float)
        l1 = np.zeros(self.N1, dtype=float)
        x1[self.seg_fwd_remap] = x
        l1[self.seg_fwd_remap] = l
        return x1, l1
