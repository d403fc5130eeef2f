"""Rearranged-genome simulator built on signed integer segment codes
(numpy).

Counterpart of ``remixt_tpu/simulations/genome.py`` without pandas:
replayable seeded rearrangement histories (double-cut-join, tandem
duplication, deletion, whole-genome doubling), particle-filter history
sampling with fitness resampling, chain-phylogeny genome collections,
mixtures with detected/false breakpoints, and read-count emission through
the model's own distributions.

A chromosome is a 1-D ``int64`` vector of nonzero *signed codes*, where
``|code| - 1 == segment_index * 2 + allele`` and the sign carries the
strand orientation. Reversal of a chromosome arm is ``-arr[::-1]``; every
rearrangement is a concatenation of array slices; copy numbers are one
``bincount`` over the concatenated code vectors; and junction (breakpoint)
accounting runs as a vectorized ``unique`` over integer junction keys.

Randomness comes from one explicit ``np.random.RandomState``, ``rng``,
that the caller passes down. The JAX package draws from numpy's global
generator and reseeds it in place at each genome event; here ``create``,
``rearrange`` and ``recreate`` reseed ``rng`` in place (``rng.seed``), so
every later draw continues from the reseeded stream exactly as there, and
a simulation from the same seed equals the JAX package's bit for bit.
Iteration over sets of breakends feeds the draws too (the shuffle of the
true breakpoints, the swarm choice), so the containers are built in the
same order as there.
"""

import collections

import numpy as np
import scipy.special
import scipy.stats

from remixt_tpu_torch import likelihood, utils
from remixt_tpu_torch.io.table import Table

_SEED_MOD = 2**32 - 1


def _draw_seed(rng):
    return int(rng.randint(_SEED_MOD))


# ---------------------------------------------------------------------------
# signed segment-copy codes
#
# code  = sign * (segment * 2 + allele + 1);  sign > 0 <=> forward strand
# ---------------------------------------------------------------------------

def _encode_copies(segments, alleles, orientations=None):
    mags = np.asarray(segments, dtype=np.int64) * 2 + np.asarray(alleles) + 1
    if orientations is None:
        return mags
    return mags * np.asarray(orientations, dtype=np.int64)


def _decode_copies(codes):
    """Return (segment, allele, orientation) integer vectors."""
    mags = np.abs(codes) - 1
    return mags >> 1, mags & 1, np.sign(codes).astype(np.int64)


def _reverse(arm):
    """Reverse-complement of a chromosome arm in code space."""
    return -arm[::-1]


# ---------------------------------------------------------------------------
# junction (breakend-pair) keys
#
# breakend = (segment, allele, side);  coded as (|code|-1) * 2 + side.
# A junction between consecutive copies (a, b) exposes the trailing end of
# a (side 1 if forward else 0) and the leading end of b (side 0 if forward
# else 1).  A breakpoint is the unordered pair, keyed lo * base + hi.
# ---------------------------------------------------------------------------

def _junction_keys(arm, n_segments):
    """Integer keys of all junctions of a circular chromosome."""
    if len(arm) == 0:
        return np.empty(0, dtype=np.int64)
    nxt = np.roll(arm, -1)
    be_a = (np.abs(arm) - 1) * 2 + (arm > 0)
    be_b = (np.abs(nxt) - 1) * 2 + (nxt < 0)
    lo = np.minimum(be_a, be_b)
    hi = np.maximum(be_a, be_b)
    return lo * (4 * n_segments) + hi


def _decode_junction_key(key, n_segments):
    """Frozenset of ((segment, allele), side) breakends for a junction key."""
    base = 4 * n_segments
    lo, hi = divmod(int(key), base)
    ends = []
    for be in (lo, hi):
        mag, side = divmod(be, 2)
        seg, allele = divmod(mag, 2)
        ends.append(((seg, allele), side))
    return frozenset(ends)


def _all_junction_keys(chromosomes, n_segments):
    keys = [_junction_keys(arm, n_segments) for arm in chromosomes]
    if not keys:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(keys)


def _segmented_dirichlet(concentration, sizes, rng):
    """Concatenated Dirichlet draws of the given sizes, via normalized gammas.

    Equivalent to ``[rng.dirichlet([c]*k) for k in sizes]`` but drawn as
    one vectorized gamma sample.
    """
    total = int(np.sum(sizes))
    gam = rng.standard_gamma(concentration, size=total)
    offsets = np.concatenate(([0], np.cumsum(sizes)[:-1])).astype(int)
    sums = np.add.reduceat(gam, offsets)
    return gam / np.repeat(sums, sizes)


class RearrangedGenome:
    """A rearranged genome: circular chromosomes of signed segment codes,
    with a stored (params, seed) event history enabling exact replay."""

    default_params = {
        'genome_length': 3e9,
        'seg_length_concentration': 1.0,
        'seg_length_min': 50000,
        'num_chromosomes': 20,
        'chrom_length_concentration': 5.,
        'chromosome_lengths': None,
        'event_type': ['dcj', 'dup', 'del', 'wgd'],
        'event_prob': [0.19, 0.3, 0.5, 0.01],
        'del_prop_len': 0.5,
        'dup_prop_len': 0.5,
        'wgd_prop_dup': 0.8,
    }

    def __init__(self, N):
        self.N = N
        self.init_params = None
        self.init_seed = None
        self.event_params = []
        self.event_seeds = []
        self._chromosomes = []

    # -- history & replay ---------------------------------------------------

    def create(self, params, rng):
        """Lay out a fresh wild-type genome under a seed drawn from ``rng``,
        which is then reseeded with it."""
        self.init_seed = _draw_seed(rng)
        self.init_params = params
        rng.seed(self.init_seed)
        self._layout_wild_type(params, rng)

    def rearrange(self, params, rng):
        """Apply one random event under a seed drawn from ``rng``, which is
        then reseeded with it."""
        seed = _draw_seed(rng)
        rng.seed(seed)
        self._apply_random_event(params, rng)
        self.event_params.append(params)
        self.event_seeds.append(seed)

    def recreate(self, rng=None):
        """Rebuild this genome exactly from its recorded seeds, reseeding
        ``rng`` (a private generator by default) at each."""
        rng = np.random.RandomState() if rng is None else rng
        rng.seed(self.init_seed)
        self._layout_wild_type(self.init_params, rng)
        for params, seed in zip(self.event_params, self.event_seeds):
            rng.seed(seed)
            self._apply_random_event(params, rng)

    def rewind(self, num_events, rng=None):
        """Drop all but the first ``num_events`` events and replay."""
        del self.event_params[num_events:]
        del self.event_seeds[num_events:]
        self.recreate(rng)

    def copy(self):
        """Independent copy; event arrays are never mutated in place, so
        chromosome vectors can be shared."""
        dup = RearrangedGenome(self.N)
        dup.init_params = self.init_params
        dup.init_seed = self.init_seed
        dup.event_params = list(self.event_params)
        dup.event_seeds = list(self.event_seeds)
        dup._chromosomes = list(self._chromosomes)
        for field in ('l', 'segment_chromosome_id', 'segment_start',
                      'segment_end', '_wt_keys'):
            if hasattr(self, field):
                setattr(dup, field, getattr(self, field))
        return dup

    # -- wild-type layout ---------------------------------------------------

    def _layout_wild_type(self, params, rng):
        """Segment the genome and build two forward-strand code vectors per
        germline chromosome."""
        fixed = params.get('chromosome_lengths', None)
        if fixed is not None:
            chrom_names = [str(c) for c in fixed.keys()]
            chrom_lengths = np.array(list(fixed.values()), dtype=float)
        else:
            k = params['num_chromosomes']
            draws = rng.standard_gamma(
                params['chrom_length_concentration'], size=k)
            chrom_lengths = np.sort(draws / draws.sum())[::-1] * params['genome_length']
            chrom_names = [str(i + 1) for i in range(k)]

        # at least one segment per chromosome; rest allocated by length
        n_chroms = len(chrom_lengths)
        seg_counts = 1 + rng.multinomial(
            self.N - n_chroms, pvals=chrom_lengths / chrom_lengths.sum())

        # per-chromosome Dirichlet length proportions, floored at the
        # minimum segment length then renormalized
        props = _segmented_dirichlet(params['seg_length_concentration'],
                                     seg_counts, rng)
        per_seg_chrom_len = np.repeat(chrom_lengths, seg_counts)
        props = np.maximum(props, params['seg_length_min'] / per_seg_chrom_len)
        offsets = np.concatenate(([0], np.cumsum(seg_counts)[:-1])).astype(int)
        props = props / np.repeat(np.add.reduceat(props, offsets), seg_counts)

        lengths = (props * per_seg_chrom_len).astype(np.int64)
        # the final segment of each chromosome absorbs integer rounding
        last = offsets + seg_counts - 1
        interior_sums = np.add.reduceat(lengths, offsets) - lengths[last]
        lengths[last] = per_seg_chrom_len[last].astype(np.int64) - interior_sums
        if not np.all(lengths > 0):
            raise ValueError('a segment of non-positive length: the '
                             'chromosomes are too short for N segments of '
                             'at least seg_length_min')

        chrom_of_seg = np.repeat(np.arange(n_chroms), seg_counts)
        # per-chromosome cumulative coordinates
        cum = np.cumsum(lengths)
        chrom_base = np.concatenate(([0], cum[last][:-1]))
        seg_end = cum - np.repeat(chrom_base, seg_counts)
        seg_start = seg_end - lengths

        self.l = lengths.astype(float)
        self.segment_chromosome_id = np.array(chrom_names, dtype=str)[chrom_of_seg]
        self.segment_start = seg_start
        self.segment_end = seg_end

        self._chromosomes = []
        for c in range(n_chroms):
            segs = np.arange(offsets[c], offsets[c] + seg_counts[c], dtype=np.int64)
            for allele in (0, 1):
                self._chromosomes.append(_encode_copies(
                    segs, np.full(len(segs), allele, dtype=np.int64)))

        self._wt_keys = np.unique(_all_junction_keys(self._chromosomes, self.N))

    # -- event machinery ----------------------------------------------------

    @property
    def chromosomes(self):
        """Decoded view: list of tuples of ((segment, allele), orientation)."""
        decoded = []
        for arm in self._chromosomes:
            seg, allele, orient = _decode_copies(arm)
            decoded.append(tuple(zip(zip(seg.tolist(), allele.tolist()),
                                     orient.tolist())))
        return decoded

    def _cut_sites(self):
        """Cumulative copy counts used to address cut sites globally.

        Cut ``t`` maps to (chromosome ``c``, position ``p``) meaning the
        circular junction *preceding* copy ``p`` of chromosome ``c``.
        """
        sizes = np.array([len(a) for a in self._chromosomes], dtype=np.int64)
        return np.cumsum(sizes)

    def _locate_cut(self, cum_sizes, t):
        c = int(np.searchsorted(cum_sizes, t, side='right'))
        p = int(t - (cum_sizes[c - 1] if c > 0 else 0))
        return c, p

    def _apply_random_event(self, params, rng):
        kind = rng.choice(params['event_type'], p=params['event_prob'])
        handler = {
            'dcj': self._event_dcj,
            'dup': self._event_duplication,
            'del': self._event_deletion,
            'wgd': self._event_wgd,
        }[kind]
        handler(params, rng)

    def _event_dcj(self, params, rng):
        """Double cut and join: sever two junctions and reconnect, with a
        coin-flip strand inversion."""
        if len(self._chromosomes) < 2:
            return
        cum = self._cut_sites()
        total = int(cum[-1])
        if total < 2:
            return
        t1 = int(rng.randint(total))
        t2 = int(rng.randint(total - 1))
        if t2 >= t1:
            t2 += 1
        (c1, p1), (c2, p2) = sorted(
            [self._locate_cut(cum, t1), self._locate_cut(cum, t2)])
        invert = bool(rng.randint(2))

        if c1 == c2:
            arm = self._chromosomes[c1]
            if invert:
                # segmental inversion between the two cuts
                rebuilt = [np.concatenate(
                    [arm[:p1], _reverse(arm[p1:p2]), arm[p2:]])]
            else:
                # excision into two circles
                rebuilt = [np.concatenate([arm[:p1], arm[p2:]]), arm[p1:p2]]
            self._replace_chromosomes([c1], rebuilt)
        else:
            a, b = self._chromosomes[c1], self._chromosomes[c2]
            if invert:
                fused = np.concatenate(
                    [a[:p1], _reverse(b[:p2]), _reverse(b[p2:]), a[p1:]])
            else:
                fused = np.concatenate([a[:p1], b[p2:], b[:p2], a[p1:]])
            self._replace_chromosomes([c1, c2], [fused])

        self._check_nonempty()

    def _event_deletion(self, params, rng):
        """Delete a circular run of copies starting at a random junction."""
        if not self._chromosomes:
            return
        cum = self._cut_sites()
        c, p = self._locate_cut(cum, int(rng.randint(int(cum[-1]))))
        arm = self._chromosomes[c]
        span = int(rng.randint(
            int(np.ceil(params['del_prop_len'] * len(arm)))))
        if span == 0:
            return
        stop = (p + span) % len(arm)
        if p < stop:
            kept = np.concatenate([arm[:p], arm[stop:]])
        else:
            kept = arm[stop:p]
        self._replace_chromosomes([c], [kept])
        self._check_nonempty()

    def _event_duplication(self, params, rng):
        """Tandem-duplicate a circular run of copies; a zero-length draw
        doubles the whole circle."""
        if not self._chromosomes:
            return
        cum = self._cut_sites()
        c, p = self._locate_cut(cum, int(rng.randint(int(cum[-1]))))
        arm = self._chromosomes[c]
        span = int(rng.randint(
            int(np.ceil(params['dup_prop_len'] * len(arm)))))
        stop = (p + span) % len(arm)
        if p < stop:
            run = arm[p:stop]
        else:
            run = np.concatenate([arm[p:], arm[:stop]])
        self._replace_chromosomes(
            [c], [np.concatenate([arm[:p], run, arm[p:]])])
        self._check_nonempty()

    def _event_wgd(self, params, rng):
        """Duplicate each chromosome independently with fixed probability."""
        keep = rng.random_sample(len(self._chromosomes)) < params['wgd_prop_dup']
        self._chromosomes.extend(
            arm for arm, dup in zip(list(self._chromosomes), keep) if dup)

    def _replace_chromosomes(self, removed_indices, added):
        for idx in sorted(removed_indices, reverse=True):
            del self._chromosomes[idx]
        self._chromosomes.extend(added)

    def _check_nonempty(self):
        if not all(len(a) > 0 for a in self._chromosomes):
            raise RuntimeError('an event left an empty chromosome')

    # -- derived state ------------------------------------------------------

    @property
    def segment_copy_number(self):
        """(N, 2) per-allele copy counts, one bincount over all codes."""
        if not self._chromosomes:
            return np.zeros((self.N, 2))
        codes = np.concatenate(self._chromosomes)
        counts = np.bincount(np.abs(codes) - 1, minlength=2 * self.N)
        return counts.reshape(self.N, 2).astype(float)

    @property
    def breakpoint_copy_number(self):
        """Counter mapping non-wild-type junctions (as breakend frozensets)
        to their copy counts."""
        keys = _all_junction_keys(self._chromosomes, self.N)
        keys = keys[~np.isin(keys, self._wt_keys)]
        uniq, counts = np.unique(keys, return_counts=True)
        out = collections.Counter()
        for key, count in zip(uniq, counts):
            out[_decode_junction_key(key, self.N)] = int(count)
        return out

    @property
    def breakpoints(self):
        return list(self.breakpoint_copy_number.keys())

    @property
    def wt_adj(self):
        """Wild-type junction set as breakend frozensets."""
        return set(_decode_junction_key(k, self.N) for k in self._wt_keys)

    # genome-composition statistics, all length-weighted

    def _masked_length(self, mask):
        return float((mask * self.l).sum())

    def length_loh(self):
        return self._masked_length(self.segment_copy_number.min(axis=1) == 0)

    def length_hdel(self):
        return self._masked_length(self.segment_copy_number.max(axis=1) == 0)

    def length_hlamp(self, hlamp_min=6):
        return self._masked_length(
            self.segment_copy_number.sum(axis=1) >= hlamp_min)

    def length_divergent(self, other):
        delta = self.segment_copy_number - other.segment_copy_number
        return float(((delta > 0).sum(axis=1) * self.l).sum())

    def proportion_loh(self):
        return self.length_loh() / float(self.l.sum())

    def proportion_hdel(self):
        return self.length_hdel() / float(self.l.sum())

    def proportion_hlamp(self, hlamp_min=6):
        return self.length_hlamp(hlamp_min=hlamp_min) / float(self.l.sum())

    def proportion_divergent(self, other):
        return self.length_divergent(other) / float(self.l.sum())

    def ploidy(self):
        total = self.segment_copy_number.sum(axis=1)
        return float((total * self.l).sum() / self.l.sum())

    def proportion_minor_state(self, cn_max=6):
        minor = np.minimum(
            self.segment_copy_number.min(axis=1), cn_max).astype(int)
        return np.bincount(minor, weights=self.l,
                           minlength=cn_max + 1) / self.l.sum()

    def proportion_major_state(self, cn_max=6):
        major = np.minimum(
            self.segment_copy_number.max(axis=1), cn_max).astype(int)
        return np.bincount(major, weights=self.l,
                           minlength=cn_max + 1) / self.l.sum()

    def segment_copy_table(self):
        """Flat table of segment copies in rearranged order, one vectorized
        decode per chromosome: columns tmr_chrom, chromosome, start, end,
        allele, orientation, length."""
        if not self._chromosomes:
            return Table([(c, np.array([], dtype=object)) for c in (
                'tmr_chrom', 'chromosome', 'start', 'end', 'allele',
                'orientation', 'length')])
        sizes = [len(arm) for arm in self._chromosomes]
        codes = np.concatenate(self._chromosomes)
        seg, allele, orient = _decode_copies(codes)
        return Table([
            ('tmr_chrom', np.repeat(np.arange(len(sizes)), sizes)),
            ('chromosome', self.segment_chromosome_id[seg]),
            ('start', self.segment_start[seg]),
            ('end', self.segment_end[seg]),
            ('allele', allele),
            ('orientation', orient),
            ('length', self.l[seg].astype(int)),
        ])

    def create_chromosome_sequences(self, germline_genome):
        """Realize nucleotide sequences; ``germline_genome`` maps
        (chromosome_id, allele) to the germline sequence string."""
        realized = []
        for arm in self._chromosomes:
            segs, alleles, orients = _decode_copies(arm)
            pieces = []
            for seg, allele, orient in zip(segs, alleles, orients):
                source = germline_genome[
                    (self.segment_chromosome_id[seg], allele)]
                piece = source[self.segment_start[seg]:self.segment_end[seg]]
                if orient < 0:
                    piece = utils.reverse_complement(piece)
                pieces.append(piece)
            realized.append(''.join(pieces))
        return realized


class RearrangementHistorySampler:
    """Sequential-importance-resampling over rearrangement histories.

    A swarm of candidate genomes each receives one random event per round;
    the swarm is then resampled in proportion to a Gaussian fitness over
    genome composition statistics.
    """

    #: statistic accessors paired with their (target, stddev) param names
    _targets = (
        (lambda g: g.proportion_hdel(), 'proportion_hdel', 0.0, 0.001),
        (lambda g: g.proportion_hlamp(), 'proportion_hlamp', 0.0, 0.001),
        (lambda g: g.ploidy(), 'ploidy', 2.5, 0.1),
        (lambda g: g.proportion_loh(), 'proportion_loh', 0.2, 0.02),
    )

    def __init__(self, params):
        self.N = params.get('N', 1000)
        self.num_swarm = params.get('num_swarm', 100)
        self.genome_params = {
            key: params.get(key, default)
            for key, default in RearrangedGenome.default_params.items()}
        self.target_specs = []
        for stat_fn, name, default_loc, default_scale in self._targets:
            self.target_specs.append((
                stat_fn,
                params.get(name, default_loc),
                params.get(name + '_stddev', default_scale),
            ))
        # attribute mirrors for introspection/tests
        for _, name, default_loc, default_scale in self._targets:
            setattr(self, name, params.get(name, default_loc))
            setattr(self, name + '_stddev',
                    params.get(name + '_stddev', default_scale))

    def sample_wild_type(self, rng):
        genome = RearrangedGenome(self.N)
        genome.create(self.genome_params, rng)
        return genome

    def genome_fitness(self, genome, fitness_callback=None):
        """Log fitness: product of Gaussians over composition statistics."""
        score = sum(
            scipy.stats.norm.logpdf(stat_fn(genome), loc=loc, scale=scale)
            for stat_fn, loc, scale in self.target_specs)
        if fitness_callback is not None:
            score = fitness_callback(genome, score)
        return score

    def resample_probs(self, genomes, fitness_callback=None):
        scores = np.array([self.genome_fitness(g, fitness_callback)
                           for g in genomes])
        return np.exp(scores - scipy.special.logsumexp(scores))

    def sample_rearrangement_history(self, genome_init, num_events, rng,
                                     fitness_callback=None):
        """Evolve the swarm ``num_events`` rounds; return it sorted by
        decreasing final resample probability."""
        swarm = [genome_init] * self.num_swarm
        for _ in range(num_events):
            advanced = []
            for genome in swarm:
                mutant = genome.copy()
                mutant.rearrange(self.genome_params, rng)
                advanced.append(mutant)
            probs = self.resample_probs(advanced, fitness_callback)
            swarm = list(rng.choice(advanced, size=self.num_swarm, p=probs))
        ranking = np.argsort(self.resample_probs(swarm))[::-1]
        return [swarm[i] for i in ranking]


# ---------------------------------------------------------------------------
# allele-collapsed breakpoint helpers
# ---------------------------------------------------------------------------

def _drop_allele(breakpoint):
    """((n, allele), side) breakends -> (n, side) breakends."""
    return frozenset((be[0][0], be[1]) for be in breakpoint)


def _sum_brk_cn_alleles(allele_brk_cn):
    """Aggregate per-allele breakpoint copy numbers over alleles."""
    totals = {}
    for bp, cn in allele_brk_cn.items():
        key = _drop_allele(bp)
        if key in totals:
            totals[key] = totals[key] + cn
        else:
            totals[key] = np.array(cn).copy()
    return totals


class GenomeCollection:
    """Normal + tumour clone genomes with aggregated copy-number state."""

    def __init__(self, genomes):
        self.genomes = genomes

        # (N, M, 2) stacked per-clone allele copy number
        self.cn = np.stack(
            [g.segment_copy_number for g in genomes], axis=1)

        # wild-type adjacencies as ordered (left_seg, right_seg) pairs
        self.adjacencies = set()
        for junction in genomes[0].wt_adj:
            pair = {}
            for (seg, _allele), side in junction:
                # side 1 is a segment's right extremity: it sits left of
                # the junction; side 0 sits right of it
                pair[side] = seg
            if set(pair) != {0, 1}:
                raise ValueError('a wild-type junction without both sides')
            self.adjacencies.add((pair[1], pair[0]))

        # allele-collapsed breakpoints present in any tumour clone
        self.breakpoints = set()
        for genome in genomes[1:]:
            self.breakpoints.update(
                _drop_allele(bp) for bp in genome.breakpoints)

        # per-clone copy number of every allele-specific breakpoint
        per_clone = [g.breakpoint_copy_number for g in genomes]
        all_bps = set()
        for counts in per_clone:
            all_bps.update(counts.keys())
        self.breakpoint_copy_number = {
            bp: np.array([counts.get(bp, 0) for counts in per_clone],
                         dtype=float)
            for bp in all_bps}

        self._find_balanced_breakpoints()

    def _find_balanced_breakpoints(self):
        """A breakpoint is balanced when, at both of its breakends, the
        flanking segments have equal total copy number in every clone."""
        self.balanced_breakpoints = set()
        for bp in self.breakpoint_copy_number:
            imbalance = 0.0
            for (seg, allele), side in bp:
                neighbour = (seg + 1) % self.N if side == 1 else (seg - 1) % self.N
                step = self.cn[seg, :, allele] - self.cn[neighbour, :, allele]
                imbalance += abs(step.sum())
            if imbalance == 0.0:
                self.balanced_breakpoints.add(bp)

    @property
    def N(self):
        return self.genomes[0].N

    @property
    def M(self):
        return len(self.genomes)

    @property
    def l(self):
        return self.genomes[0].l

    @property
    def segment_chromosome_id(self):
        return self.genomes[0].segment_chromosome_id

    @property
    def segment_start(self):
        return self.genomes[0].segment_start

    @property
    def segment_end(self):
        return self.genomes[0].segment_end

    def length_divergent(self):
        # divergence between the two tumour clones; a monoclonal collection
        # (wild type + one descendant) has no clone pair to diverge
        if len(self.genomes) < 3:
            return 0.0
        return self.genomes[1].length_divergent(self.genomes[2])

    def length_loh(self):
        return [g.length_loh() for g in self.genomes]

    def length_hdel(self):
        return [g.length_hdel() for g in self.genomes]

    def length_hlamp(self, hlamp_min=6):
        return [g.length_hlamp(hlamp_min=hlamp_min) for g in self.genomes]

    def collapsed_breakpoint_copy_number(self):
        return _sum_brk_cn_alleles(self.breakpoint_copy_number)

    def collapsed_minimal_breakpoint_copy_number(self):
        from remixt_tpu_torch.simulations import balanced
        minimal = balanced.minimize_breakpoint_copies(
            self.adjacencies, self.breakpoint_copy_number)
        return _sum_brk_cn_alleles(minimal)

    def collapsed_balanced_breakpoints(self):
        return set(_drop_allele(bp) for bp in self.balanced_breakpoints)


def _accept_first(sample_once, predicates, max_tries, failure):
    """Repeatedly draw ranked candidate lists until one candidate passes
    every predicate; returns that candidate."""
    for _ in range(max_tries):
        candidates = sample_once()
        for predicate in predicates:
            candidates = [c for c in candidates if predicate(c)]
            if not candidates:
                break
        if candidates:
            return candidates[0]
    raise ValueError(failure)


class GenomeCollectionSampler:
    """Chain phylogeny sampler: wild type -> ancestor -> M-1 subclones.

    The ancestor is an intermediate (not itself a mixture clone): the
    collection holds the wild type plus M-1 descendants that share the
    ancestral events. Candidates are filtered on ploidy, LOH, and
    subclonal-divergence windows, with bounded retries.
    """

    def __init__(self, rearrangement_history_sampler, params):
        self.rh_sampler = rearrangement_history_sampler
        self.M = params['M']
        self.num_ancestral_events = params.get('num_ancestral_events', 25)
        self.num_descendent_events = params.get('num_descendent_events', 10)
        self.ploidy = params.get('ploidy', 2.5)
        self.ploidy_max_error = params.get('ploidy_max_error', 0.2)
        self.proportion_loh = params.get('proportion_loh', 0.2)
        self.proportion_loh_max_error = params.get(
            'proportion_loh_max_error', 0.02)
        self.proportion_subclonal = params.get('proportion_subclonal', 0.3)
        self.proportion_subclonal_max_error = params.get(
            'proportion_subclonal_max_error', 0.02)
        self.proportion_subclonal_stddev = params.get(
            'proportion_subclonal_stddev', 0.02)

    def sample_genome_collection(self, rng, max_tries=100):
        wild_type = self.rh_sampler.sample_wild_type(rng)

        ancestor = _accept_first(
            lambda: self.rh_sampler.sample_rearrangement_history(
                wild_type, self.num_ancestral_events, rng),
            [
                lambda g: abs(g.ploidy() - self.ploidy) < self.ploidy_max_error,
                lambda g: abs(g.proportion_loh() - self.proportion_loh)
                < self.proportion_loh_max_error,
            ],
            max_tries, 'unable to simulate ancestral genome')

        def descendant_fitness(genome, score):
            return score + scipy.stats.norm.logpdf(
                genome.proportion_divergent(ancestor),
                loc=self.proportion_subclonal,
                scale=self.proportion_subclonal_stddev)

        genomes = [wild_type]
        for _ in range(self.M - 1):
            genomes.append(_accept_first(
                lambda: self.rh_sampler.sample_rearrangement_history(
                    ancestor, self.num_descendent_events, rng,
                    fitness_callback=descendant_fitness),
                [
                    lambda g: abs(g.proportion_divergent(ancestor)
                                  - self.proportion_subclonal)
                    < self.proportion_subclonal_max_error,
                ],
                max_tries, 'unable to simulate descendant genome'))

        return GenomeCollection(genomes)


def sample_random_breakpoints(N, num_breakpoints, adjacencies, rng,
                              excluded_breakpoints=None):
    """Draw false-positive breakpoints by batched rejection sampling,
    excluding wild-type-mimicking junctions and fold-back self-pairs."""
    excluded = set() if excluded_breakpoints is None else set(excluded_breakpoints)
    found = set()
    while len(found) < num_breakpoints:
        batch = max(16, 2 * (num_breakpoints - len(found)))
        segs = rng.randint(N, size=(batch, 2))
        sides = rng.randint(2, size=(batch, 2))
        for (n1, n2), (s1, s2) in zip(segs, sides):
            n1, n2, s1, s2 = int(n1), int(n2), int(s1), int(s2)
            if (s1, s2) == (1, 0) and (n1, n2) in adjacencies:
                continue
            if (s2, s1) == (1, 0) and (n2, n1) in adjacencies:
                continue
            if (n1, s1) == (n2, s2):
                continue
            bp = frozenset([(n1, s1), (n2, s2)])
            if bp in excluded or bp in found:
                continue
            found.add(bp)
            if len(found) == num_breakpoints:
                break
    return found


def _breakpoint_table(detected_breakpoints, collection):
    """Tabulate detected breakpoints with genomic coordinates/strands."""
    rows = []
    for prediction_id, bp in detected_breakpoints.items():
        row = {'prediction_id': prediction_id}
        # a fold-back junction collapses to a single breakend; write it as
        # both sides so the _2 columns are never NaN (downstream readers
        # parse position_2 as int)
        breakends = sorted(bp) * 2 if len(bp) == 1 else bp
        for k, (seg, side) in enumerate(breakends, start=1):
            row['n_{}'.format(k)] = seg
            row['side_{}'.format(k)] = side
            row['chromosome_{}'.format(k)] = collection.segment_chromosome_id[seg]
            row['strand_{}'.format(k)] = '+' if side == 1 else '-'
            row['position_{}'.format(k)] = (
                collection.segment_end[seg] if side == 1
                else collection.segment_start[seg])
        rows.append(row)
    return Table.from_records(rows)


class GenomeMixture:
    """Clone mixture: genome collection + fractions + detected breakpoints."""

    def __init__(self, genome_collection, frac, detected_breakpoints):
        self.genome_collection = genome_collection
        self.frac = frac
        self.detected_breakpoints = detected_breakpoints
        self.breakpoint_segment_data = _breakpoint_table(
            detected_breakpoints, genome_collection)

    def __getattr__(self, name):
        # delegate shared genome attributes to the collection
        if name in ('N', 'M', 'l', 'cn', 'adjacencies', 'breakpoints',
                    'segment_chromosome_id', 'segment_start', 'segment_end'):
            return getattr(self.genome_collection, name)
        raise AttributeError(name)


class GenomeMixtureSampler:
    """Sample clone fractions and the detected + false breakpoint set."""

    def __init__(self, params):
        self.frac_normal = params.get('frac_normal', 0.4)
        self.frac_clone_concentration = params.get('frac_clone_concentration', 1.)
        self.frac_clone_1 = params.get('frac_clone_1', None)
        self.num_false_breakpoints = params.get('num_false_breakpoints', 50)
        self.proportion_breakpoints_detected = params.get(
            'proportion_breakpoints_detected', 0.9)

    def _sample_fractions(self, M, rng):
        tumour_total = 1.0 - self.frac_normal
        if self.frac_clone_1 is None:
            draws = rng.standard_gamma(
                self.frac_clone_concentration, size=M - 1)
            tumour = draws / draws.sum() * tumour_total
        elif M == 3:
            tumour = np.array(
                [self.frac_clone_1, tumour_total - self.frac_clone_1])
        elif M == 4:
            rest_total = tumour_total - self.frac_clone_1
            draws = rng.standard_gamma(
                self.frac_clone_concentration, size=M - 2)
            tumour = np.concatenate(
                [[self.frac_clone_1], draws / draws.sum() * rest_total])
        else:
            raise ValueError(
                'frac_clone_1 supported only for M in (3, 4), got {}'.format(M))
        frac = np.concatenate([[self.frac_normal], tumour])
        if abs(frac.sum() - 1.0) >= 1e-8:
            raise ValueError('clone fractions sum to {}'.format(frac.sum()))
        return frac

    def sample_genome_mixture(self, genome_collection, rng):
        frac = self._sample_fractions(genome_collection.M, rng)

        true_bps = list(genome_collection.breakpoints)
        rng.shuffle(true_bps)
        num_detected = int(
            self.proportion_breakpoints_detected * len(true_bps))
        detected = true_bps[:num_detected]

        detected.extend(sample_random_breakpoints(
            genome_collection.N,
            self.num_false_breakpoints,
            genome_collection.adjacencies,
            rng,
            excluded_breakpoints=genome_collection.breakpoints))

        return GenomeMixture(
            genome_collection, frac, dict(enumerate(detected)))


class Experiment:
    """Read counts emitted over a known mixture.

    Carries what the fit reads (``x``, and through the mixture ``N``,
    ``M``, ``l``, ``cn``, ``adjacencies`` and the ``segment_*``
    coordinates), the detected ``breakpoints`` with their
    ``breakpoint_segment_data``, ``chains``, and the truth: ``h``, ``phi``
    and, for the negbin-betabin emission, ``is_outlier_total``,
    ``is_outlier_allele`` and ``segment_major_is_allele_a``.
    """

    def __init__(self, genome_mixture, h, phi, x, h_pred, **extra):
        self.genome_mixture = genome_mixture
        self.h = h
        self.phi = phi
        self.x = x
        self.h_pred = h_pred
        self.__dict__.update(extra)

    def __getattr__(self, name):
        if name in ('N', 'M', 'l', 'cn', 'adjacencies',
                    'segment_chromosome_id', 'segment_start', 'segment_end'):
            return getattr(self.genome_mixture, name)
        raise AttributeError(name)

    @property
    def chains(self):
        """Maximal runs of wild-type-adjacent segments, as (start, end)."""
        boundaries = [0]
        for n in range(self.N - 1):
            if (n, n + 1) not in self.adjacencies:
                boundaries.append(n + 1)
        boundaries.append(self.N)
        return zip(boundaries[:-1], boundaries[1:])

    @property
    def breakpoints(self):
        return self.genome_mixture.detected_breakpoints

    @property
    def breakpoint_segment_data(self):
        return self.genome_mixture.breakpoint_segment_data


# -- count emission ---------------------------------------------------------

def _negbin_draw(mu, r, rng):
    return rng.negative_binomial(r, r / (r + mu + 1e-16))


def _betabin_draw(n, p, M, rng):
    return rng.binomial(n, rng.beta(M * p, M * (1 - p)))


def _mixture_draw(draw_inlier, draw_outlier, outlier_prob, shape, rng):
    is_outlier = rng.random_sample(size=shape) < outlier_prob
    return np.where(is_outlier, draw_outlier(), draw_inlier()), is_outlier


class ExperimentSampler:
    """Emit read counts for a mixture through the model's distributions
    (negbin totals + betabin allele ratios, with outlier components)."""

    _emission_models = ('poisson', 'negbin', 'negbin_betabin')

    def __init__(self, params):
        self.h_total = params.get('h_total', 0.1)
        self.phi_min = params.get('phi_min', 0.05)
        self.phi_max = params.get('phi_max', 0.2)
        self.emission_model = params.get('emission_model', 'negbin_betabin')
        if self.emission_model not in self._emission_models:
            raise ValueError('emission_model must be one of {}'.format(
                self._emission_models))
        self.frac_beta_noise_stddev = params.get('frac_beta_noise_stddev', None)
        self.params = dict(params)

    def _emit_counts(self, mu, phi, rng):
        """Return ((N,3) allele-a/allele-b/total counts, extra params)."""
        extra = {}
        if self.emission_model == 'poisson':
            return rng.poisson(mu + 1e-16).astype(float), extra

        if self.emission_model == 'negbin':
            r = self.params.get('negbin_r', 500.)
            extra['negbin_r'] = r
            return _negbin_draw(mu, r, rng).astype(float), extra

        # negbin totals + betabin allele split, each a 2-component
        # inlier/outlier mixture
        r_0 = self.params.get('negbin_r_0', 1000.)
        r_1 = self.params.get('negbin_r_1', 10.)
        total_outlier_prob = self.params.get('negbin_mix', 0.01)
        M_0 = self.params.get('betabin_M_0', 2000.)
        M_1 = self.params.get('betabin_M_1', 10.)
        allele_outlier_prob = self.params.get('betabin_mix', 0.01)

        mu_total = mu[:, 2] + 1e-16
        total, is_outlier_total = _mixture_draw(
            lambda: _negbin_draw(mu_total, r_0, rng),
            lambda: _negbin_draw(mu_total, r_1, rng),
            total_outlier_prob, mu_total.shape, rng)

        genotypable = (phi * total).astype(int)
        p_a = np.clip(mu[:, 0] / (mu[:, 0] + mu[:, 1] + 1e-16), 1e-6, 1 - 1e-6)
        count_a, is_outlier_allele = _mixture_draw(
            lambda: _betabin_draw(genotypable, p_a, M_0, rng),
            lambda: _betabin_draw(genotypable, p_a, M_1, rng),
            allele_outlier_prob, p_a.shape, rng)

        extra['is_outlier_total'] = is_outlier_total
        extra['is_outlier_allele'] = is_outlier_allele
        counts = np.stack(
            [count_a, genotypable - count_a, total], axis=1).astype(float)
        return counts, extra

    def _perturb_fractions(self, frac, rng):
        """Beta-noise the clone fractions when configured."""
        if self.frac_beta_noise_stddev is None:
            return frac
        var = self.frac_beta_noise_stddev ** 2
        if np.any(var >= frac * (1. - frac)):
            raise ValueError('var >= mu * (1. - mu)')
        nu = frac * (1. - frac) / var - 1.
        return rng.beta(frac * nu, (1 - frac) * nu)

    def sample_experiment(self, genome_mixture, rng):
        h = genome_mixture.frac * self.h_total
        phi = rng.uniform(
            self.phi_min, self.phi_max, size=genome_mixture.N)
        mu = likelihood.expected_read_count(
            genome_mixture.l, genome_mixture.cn, h, phi)

        x, extra = self._emit_counts(mu, phi, rng)

        # order the allele columns major/minor, remembering which was a
        major_is_a = x[:, 0] > x[:, 1]
        major = np.where(major_is_a, x[:, 0], x[:, 1])
        minor = np.where(major_is_a, x[:, 1], x[:, 0])
        x = np.stack([major, minor, x[:, 2]], axis=1)
        extra['segment_major_is_allele_a'] = major_is_a.astype(int)

        h_pred = self._perturb_fractions(genome_mixture.frac, rng) * self.h_total

        return Experiment(genome_mixture, h, phi, x, h_pred, **extra)
