"""Read-count measurability (numpy).

Counterpart of ``estimate_phi`` and ``proportion_measureable_matrix`` of
``remixt_tpu/likelihood.py``, which the read-depth initialization reads.
"""

import numpy as np


def estimate_phi(x):
    """Proportion of genotypable reads per segment from the count matrix
    (major, minor, total)."""
    return x[:, 0:2].sum(axis=1).astype(float) / (x[:, 2].astype(float) + 1.0)


def proportion_measureable_matrix(phi):
    """(N, 3) per-measurement measurable proportions: phi for the allele
    measurements, 1 for the total."""
    return np.stack([phi, phi, np.ones_like(phi)], axis=1)
