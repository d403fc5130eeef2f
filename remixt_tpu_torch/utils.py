"""Host-side utilities (numpy).

Counterpart of ``weighted_resample`` and ``reverse_complement`` of
``remixt_tpu/utils/__init__.py``.
"""

import numpy as np


def weighted_resample(data, weights, num_samples=10000, seed=1234):
    """Multinomial resample of ``data`` proportional to ``weights``.

    Draws from a private ``np.random.RandomState(seed)``, so callers'
    random streams are untouched and the draw equals the JAX package's.
    """
    p = np.asarray(weights, dtype=float)
    counts = np.random.RandomState(seed).multinomial(num_samples, p / p.sum())
    return np.repeat(data, counts)


_DNA_COMPLEMENT = str.maketrans('ACTGactg', 'TGACtgac')


def reverse_complement(sequence):
    """Reverse complement of a DNA string."""
    return sequence.translate(_DNA_COMPLEMENT)[::-1]
