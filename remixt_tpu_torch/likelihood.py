"""Read-count measurability (numpy).

Counterpart of ``estimate_phi``, ``proportion_measureable_matrix`` and
``expected_read_count`` of ``remixt_tpu/likelihood.py``, which the
read-depth initialization and the genome simulation's count emission read.
"""

import numpy as np

#: rows = (allele a, allele b), columns = (a reads, b reads, total reads)
allele_measurement_matrix = np.array([[1, 0, 1], [0, 1, 1]])


class ProbabilityError(ValueError):
    def __init__(self, message, **variables):
        for name, value in variables.items():
            message += '\n{}={}'.format(name, value)
        super().__init__(message)


def estimate_phi(x):
    """Proportion of genotypable reads per segment from the count matrix
    (major, minor, total)."""
    return x[:, 0:2].sum(axis=1).astype(float) / (x[:, 2].astype(float) + 1.0)


def proportion_measureable_matrix(phi):
    """(N, 3) per-measurement measurable proportions: phi for the allele
    measurements, 1 for the total."""
    return np.stack([phi, phi, np.ones_like(phi)], axis=1)


def expected_read_count(l, cn, h, phi):
    """mu[n, k] = l_n * phi-weighting * per-allele depth, for measurements
    k = (allele a, allele b, total)."""
    allele_depth = np.einsum('nma,m->na', cn, h)        # (N, 2)
    measurement_depth = allele_depth @ allele_measurement_matrix  # (N, 3)
    mu = measurement_depth * proportion_measureable_matrix(phi) * l[:, None]
    mu = mu + 1e-16

    bad = ~np.isfinite(mu) | (mu <= 0)
    if np.any(bad):
        n = int(np.where(bad.any(axis=1))[0][0])
        raise ProbabilityError('invalid mu', n=n, cn=cn[n], l=l[n], h=h,
                               phi=phi[n], mu=mu[n])
    return mu
