"""Count-level experiment simulation with ground truth.

A copy of ``simulate_experiment`` and its helpers from
``remixt_tpu/simulations/simple.py``: a tumour profile built by replaying
deletion/duplication events, read counts emitted through the model's own
distributions (negative binomial totals, beta-binomial allele ratios), and
breakpoints derived from the events, giving fully ground-truthed fixtures
for the tests and ``chip_smoke.py``.
"""

import numpy as np


def apply_events(N, M, num_events, cn_max, cn_diff_max, ploidy_allele=1,
                 mean_span=8, rng=None, max_attempts=50):
    """Generate a tumour profile by replaying deletion/duplication events.

    Each event removes or duplicates a span [a, b] on one allele in either a
    single tumour clone or all tumour clones (ancestral), and creates the
    correspondingly oriented breakpoint — a deletion joins (a-1, end) to
    (b+1, start); a tandem duplication joins (b, end) to (a, start). This is
    the count-level analogue of the reference's rearranged-genome event
    replay (simulations/experiment.py:294-444) and produces breakpoints whose
    copy number is consistent at both breakends.

    Returns:
        cn (N, M, 2) int, breakpoints dict, brk_cn dict (ground-truth
        breakpoint copy number per clone)
    """
    if rng is None:
        rng = np.random.RandomState()
    cn = np.ones((N, M, 2), dtype=int)
    cn[:, 1:, :] = ploidy_allele

    breakpoints = {}
    brk_cn = {}
    bp_to_id = {}
    bp_id = 0

    def valid(c):
        if np.any(c < 0):
            return False
        if np.any(c[:, 1:, :].sum(axis=-1) > cn_max):
            return False
        diffs = c[:, 1:, :].max(axis=1) - c[:, 1:, :].min(axis=1)
        return not np.any(diffs > cn_diff_max)

    for _ in range(num_events):
        for _ in range(max_attempts):
            a = rng.randint(1, N - 1)
            b = min(a + rng.geometric(1.0 / mean_span) - 1, N - 2)
            allele = rng.randint(2)
            is_ancestral = rng.rand() < 0.5
            clones = list(range(1, M)) if is_ancestral else [rng.randint(1, M)]
            delta = rng.choice([-1, 1])

            new_cn = cn.copy()
            for m in clones:
                new_cn[a:b + 1, m, allele] += delta
            if not valid(new_cn):
                continue

            cn = new_cn
            if delta < 0:
                bp = frozenset([(a - 1, 1), (b + 1, 0)])
            else:
                bp = frozenset([(b, 1), (a, 0)])
            cn_b = np.zeros(M, dtype=int)
            for m in clones:
                cn_b[m] = 1
            if bp in bp_to_id:
                # repeated event on the same span accumulates copies
                brk_cn[bp_to_id[bp]] = brk_cn[bp_to_id[bp]] + cn_b
            else:
                bp_to_id[bp] = bp_id
                breakpoints[bp_id] = bp
                brk_cn[bp_id] = cn_b
                bp_id += 1
            break

    return cn, breakpoints, brk_cn


def sample_negbin(rng, mu, r):
    """Sample negative binomial with mean mu, dispersion r."""
    mu = np.maximum(mu, 1e-8)
    p = r / (r + mu)
    return rng.negative_binomial(r, p)


def sample_betabin(rng, n, p, M):
    """Sample beta-binomial with mean fraction p, precision M."""
    a, b = M * p, M * (1 - p)
    ps = rng.beta(a, b, size=np.shape(n))
    return rng.binomial(n, ps)


def simulate_experiment(N=100, M=3, h=(0.08, 0.06, 0.03), num_events=None,
                        cn_max=6, cn_diff_max=1, mean_span=8,
                        mean_length=5e5, frac_genotyped=0.25,
                        negbin_r=500.0, betabin_M=500.0, seed=0,
                        num_chains=1):
    """Simulate a count-level experiment with fully consistent ground truth.

    The tumour profile is built by replaying deletion/duplication events, so
    every breakpoint's copy number is consistent at both breakends and within
    the (cn_max, cn_diff_max) model family. Read counts are emitted through
    the model's own distributions (the count-level analogue of the
    reference's ExperimentSampler, simulations/experiment.py:1222-1399).

    Returns dict with: cn (N, M, 2) truth, h (M,), x (N, 3) major/minor/total
    counts, l (N,), adjacencies, breakpoints (id -> frozenset of breakends),
    brk_cn (id -> per-clone true breakpoint copies), negbin_r, betabin_M.
    """
    rng = np.random.RandomState(seed)
    h = np.asarray(h, dtype=float)
    if num_events is None:
        num_events = max(2, N // 8)

    cn, breakpoints, brk_cn = apply_events(
        N, M, num_events, cn_max, cn_diff_max, rng=rng, mean_span=mean_span)

    l = rng.uniform(0.5 * mean_length, 1.5 * mean_length, size=N)

    total_depth = np.einsum('nml,m->n', cn, h)
    mu = l * total_depth
    x_total = sample_negbin(rng, mu, negbin_r).astype(float)

    a0_depth = np.einsum('nm,m->n', cn[:, :, 0], h)
    ratio = np.where(total_depth > 0, a0_depth / np.maximum(total_depth, 1e-12), 0.5)
    ratio = np.clip(ratio, 1e-3, 1 - 1e-3)

    allele_total = rng.binomial(x_total.astype(int), frac_genotyped).astype(float)
    a0_count = sample_betabin(rng, allele_total.astype(int), ratio, betabin_M).astype(float)
    a1_count = allele_total - a0_count

    x = np.stack([np.maximum(a0_count, a1_count),
                  np.minimum(a0_count, a1_count),
                  x_total], axis=-1)

    # split the genome into independent chains (chromosome analogue): drop
    # the wild-type adjacency at chain boundaries
    adjacencies = set((n, n + 1) for n in range(N - 1))
    if num_chains > 1:
        bounds = np.linspace(0, N, num_chains + 1).astype(int)[1:-1]
        for b in bounds:
            adjacencies.discard((b - 1, b))

    return dict(
        cn=cn, h=h, x=x, l=l,
        adjacencies=adjacencies, breakpoints=breakpoints, brk_cn=brk_cn,
        negbin_r=negbin_r, betabin_M=betabin_M,
    )
