"""Fit initialization: read-depth modes and candidate haploid depths
(numpy).

Counterpart of ``remixt_tpu/analysis/readdepth.py`` without pandas and
without scikit-learn: a per-segment depth table restricted to usable
segments, k-means modes of the length-weighted minor-allele depth
distribution, candidate monoclonal (normal, tumour) haploid depth pairs,
and a raw-copy-number ploidy estimate per candidate.

The JAX package clusters with ``sklearn.cluster.KMeans(n_clusters=5,
n_init=10)`` drawing from numpy's global generator, which its ``init``
seeds with the config's ``random_seed``. :func:`kmeans_1d` is its numpy
counterpart in one dimension: it draws from an explicit
``np.random.RandomState(random_seed)`` in scikit-learn's order and runs
its algorithm, so the two take the same draws and agree to rounding (the
order of the sums differs), within the tolerance that
``tests/test_torch_readdepth.py`` states.
"""

import numpy as np

from remixt_tpu_torch import likelihood, utils
from remixt_tpu_torch.io.table import Table


def calculate_depth(experiment):
    """Depth table: minor, major and total depth per segment with a
    ``high_quality`` indicator.

    A segment is high quality when its effective length, genotypable read
    count and effective-to-genomic length ratio each clear the 10th
    percentile. Rows whose depths are undefined (zero effective length or
    zero genotypable proportion) are dropped; the index keeps the others'
    segment positions.
    """
    if experiment.segment_start is None:
        raise ValueError(
            'the read depths need the segment coordinates, which an '
            'Experiment built from arrays lacks; build it with '
            'Experiment.from_tables or create_experiment')
    x = np.asarray(experiment.x, dtype=float)
    l = np.asarray(experiment.l, dtype=float)
    genomic_span = (np.asarray(experiment.segment_end)
                    - np.asarray(experiment.segment_start) + 1)

    with np.errstate(invalid='ignore', divide='ignore'):
        allele_ratio = np.nan_to_num(x[:, 1] / (x[:, 0] + x[:, 1]))
        total = x[:, 2] / l
    minor = total * allele_ratio
    major = total * (1.0 - allele_ratio)

    high_quality = np.ones(len(l), dtype=bool)
    for score in (l, x[:, 0] + x[:, 1], l / genomic_span):
        high_quality &= score > np.percentile(score, 10)

    phi = likelihood.estimate_phi(x)
    measurable = likelihood.proportion_measureable_matrix(phi)
    defined = (l > 0) & np.all(measurable > 0, axis=1)

    return Table([
        ('chromosome', experiment.segment_chromosome_id),
        ('start', experiment.segment_start),
        ('end', experiment.segment_end),
        ('length', l),
        ('major', major),
        ('minor', minor),
        ('total', total),
        ('high_quality', high_quality),
    ]).take(defined)


def _sq_dist(centres, x):
    """Squared distances (len(centres), len(x)), in scikit-learn's
    arithmetic for one feature: -2·c·x + c² + x²."""
    c = np.asarray(centres, dtype=float)[:, None]
    return np.maximum(-2. * (c * x[None, :]) + c * c + x[None, :] * x, 0.)


def _kmeans_plus_plus(x, num_clusters, rng):
    """Greedy k-means++ seeding of 1-D ``x``, drawing from ``rng`` in
    scikit-learn's order: the first centre by ``choice``, then per centre
    2 + log(k) candidates by ``uniform``, keeping the one that most lowers
    the potential."""
    n_local_trials = 2 + int(np.log(num_clusters))
    weights = np.ones(len(x))
    centres = np.empty(num_clusters)
    centres[0] = x[rng.choice(len(x), p=weights / weights.sum())]
    closest = _sq_dist(centres[:1], x)[0]
    potential = closest @ weights
    for c in range(1, num_clusters):
        draws = rng.uniform(size=n_local_trials) * potential
        candidates = np.minimum(
            np.searchsorted(np.cumsum(weights * closest), draws), len(x) - 1)
        dist = np.minimum(closest, _sq_dist(x[candidates], x))
        potentials = dist @ weights
        best = int(np.argmin(potentials))
        potential, closest = potentials[best], dist[best]
        centres[c] = x[candidates[best]]
    return centres


def _assign(x, centres):
    """Nearest centre of each point (the first on a tie)."""
    return np.argmin(centres * centres - 2. * (x[:, None] * centres), axis=1)


def _lloyd(x, centres, max_iter, tol):
    """Lloyd iterations from ``centres``, as scikit-learn runs them: stop
    when the labels repeat, or when the squared centre shift is at most
    ``tol`` (and then label once more by the final centres). An empty
    cluster is re-seeded at the point farthest from its centre.

    Returns (centres, labels).
    """
    k = len(centres)
    labels_old = np.full(len(x), -1)
    for _ in range(max_iter):
        labels = _assign(x, centres)
        counts = np.bincount(labels, minlength=k).astype(float)
        sums = np.bincount(labels, weights=x, minlength=k)
        empty = np.flatnonzero(counts == 0)
        if len(empty):
            far = np.argpartition((x - centres[labels]) ** 2,
                                  -len(empty))[:-len(empty) - 1:-1]
            for cluster, point in zip(empty, far):
                sums[labels[point]] -= x[point]
                counts[labels[point]] -= 1.
                sums[cluster], counts[cluster] = x[point], 1.
        new = np.where(counts > 0, sums / np.maximum(counts, 1.), 0.)
        shift = ((new - centres) ** 2).sum()
        centres = new
        if np.array_equal(labels, labels_old):
            return centres, labels
        if shift <= tol:
            return centres, _assign(x, centres)
        labels_old = labels
    return centres, _assign(x, centres)


def _same_clustering(labels1, labels2):
    """Whether every cluster of ``labels1`` is within one of ``labels2``."""
    pairs = np.unique(np.stack([labels1, labels2]), axis=1)
    return len(np.unique(pairs[0])) == pairs.shape[1]


def kmeans_1d(x, num_clusters, rng, n_init=10, max_iter=300, tol=1e-4):
    """k-means of 1-D ``x`` as ``sklearn.cluster.KMeans(num_clusters,
    n_init=n_init)`` computes it with ``random_state=rng``: the data
    centred on its mean, k-means++ seeding, Lloyd iterations with a
    tolerance of ``tol`` times the data's variance, and of ``n_init`` runs
    the first of lowest inertia (a later run replaces it only with a lower
    inertia and a different clustering).

    Returns (centres (num_clusters,), labels (len(x),)).
    """
    x = np.asarray(x, dtype=float)
    tol = np.var(x) * tol
    mean = x.mean()
    x = x - mean
    best = None
    for _ in range(n_init):
        centres, labels = _lloyd(
            x, _kmeans_plus_plus(x, num_clusters, rng), max_iter, tol)
        inertia = float(((x - centres[labels]) ** 2).sum())
        if best is None or (inertia < best[0]
                            and not _same_clustering(labels, best[2])):
            best = (inertia, centres, labels)
    return best[1] + mean, best[2]


def calculate_minor_modes(read_depth, num_clusters=5, min_cluster_prop=0.01,
                          return_masses=False, random_seed=1234):
    """Modes of the length-weighted minor-allele depth distribution.

    Depths above the 95th percentile (amplifications) are excluded, the
    rest resampled in proportion to segment length, clustered with
    :func:`kmeans_1d` (seeded ``np.random.RandomState(random_seed)``), and
    clusters holding under ``min_cluster_prop`` of the mass discarded. The
    modes are sorted ascending; with ``return_masses`` each surviving
    mode's mass fraction comes too.
    """
    minor = read_depth['minor']
    keep = minor < np.percentile(minor, 95)
    samples = utils.weighted_resample(minor[keep], read_depth['length'][keep])

    centres, labels = kmeans_1d(samples, num_clusters,
                                np.random.RandomState(random_seed))
    proportion = np.bincount(
        labels, minlength=num_clusters) / float(len(labels))
    surviving = proportion >= min_cluster_prop
    modes, masses = centres[surviving], proportion[surviving]
    order = np.argsort(modes)
    if not return_masses:
        return modes[order]
    return modes[order], masses[order]


def calculate_candidate_h_monoclonal(minor_modes, h_normal=None,
                                     h_tumour=None, mode_masses=None,
                                     normal_mass_tolerance=0.05):
    """Candidate (normal, tumour) haploid depth pairs.

    With ``mode_masses``, every mode with at most ``normal_mass_tolerance``
    of the distribution's mass strictly below it is tried as the normal
    anchor (0, or no masses, anchors the smallest mode alone). Per anchor,
    every higher mode yields two tumour-depth candidates: the mode's
    offset, and half of it. Near-duplicate candidates (2 % relative) are
    merged.
    """
    minor_modes = np.asarray(minor_modes)
    if h_tumour is not None:
        if h_normal is None:
            h_normal = minor_modes.min()
        return np.array([[h_normal, h_tumour]])

    if h_normal is not None:
        anchors = [float(h_normal)]
    elif mode_masses is None or normal_mass_tolerance <= 0.0:
        anchors = [float(minor_modes.min())]
    else:
        order = np.argsort(minor_modes)
        modes_sorted = minor_modes[order]
        masses_sorted = np.asarray(mode_masses, dtype=float)[order]
        mass_below = np.concatenate([[0.0], np.cumsum(masses_sorted)[:-1]])
        anchors = [float(m) for m, below in zip(modes_sorted, mass_below)
                   if below <= normal_mass_tolerance]

    candidates = []
    for anchor in anchors:
        offsets = minor_modes[minor_modes > anchor] - anchor
        for offset in offsets:
            for scale in (1.0, 0.5):
                candidates.append(np.array([anchor, offset * scale]))

    deduped = []
    for cand in candidates:
        if not any(np.all(np.abs(cand - kept) <= 0.02 * np.abs(kept))
                   for kept in deduped):
            deduped.append(cand)
    return deduped


def estimate_ploidy(h, experiment):
    """Length-weighted mean total raw copy number under candidate ``h``."""
    depth = calculate_depth(experiment)
    h = np.asarray(h, dtype=float)
    raw_total = (depth['major'] + depth['minor'] - 2.0 * h[0]) / h[1:].sum()
    length = depth['length']
    finite = np.isfinite(raw_total)
    return float((raw_total[finite] * length[finite]).sum()
                 / length[finite].sum())
