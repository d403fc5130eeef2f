"""The sample a fit reads (numpy).

Counterpart of the fields of ``Experiment`` of ``remixt_tpu/analysis/experiment.py``
that the fit reads. Building it from count and breakpoint TSV tables is not
ported yet; callers pass the arrays.
"""

import numpy as np


class Experiment:
    """Read counts, segment lengths and the breakpoint graph of one sample.

    Args:
        x: (N, 3) major, minor and total read counts per segment
        l: (N,) segment lengths
        adjacencies: set of (n, n+1) wild-type adjacent segment pairs
        breakpoints: {breakpoint id: frozenset of two (segment, side)}
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
        self.breakpoints = dict(breakpoints)
        if segment_chromosome_id is None:
            segment_chromosome_id = np.full(self.x.shape[0], '1')
        self.segment_chromosome_id = np.asarray(segment_chromosome_id)
