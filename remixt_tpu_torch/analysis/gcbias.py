"""GC and mappability bias model (numpy, scipy).

Counterpart of ``remixt_tpu/analysis/gcbias.py``: random-position
read-start sampling, a LOWESS read-rate curve over GC, and the per-segment
expected-bias integral over the fragment-length distribution, GC curve
and mappability, which rescales segment length into the effective length
the likelihood uses.

The mappability store follows the seqdata rule: a name ending in ``.h5`` is
the JAX package's HDF5 store (group ``chromosome_X`` with ``start``,
``end`` and ``quality`` datasets; h5py imported inside the function); any
other name is a directory with ``chromosome_X/start.npy``, ``end.npy`` and
``quality.npy``. A FASTA with its ``.fai`` beside it is read by seeking to
each chromosome; without one it is scanned.
"""

import os

import numpy as np
import scipy.stats

import remixt_tpu_torch.config
from remixt_tpu_torch import seqdataio
from remixt_tpu_torch.io.store import is_hdf5
from remixt_tpu_torch.io.table import Table, read_tsv, write_tsv
from remixt_tpu_torch.utils import read_sequences


def _param(config, name):
    return remixt_tpu_torch.config.get_param(config, name)


def _ref_file(config, ref_data_dir, name):
    return remixt_tpu_torch.config.get_filename(config, ref_data_dir, name)


def lowess(y, x, frac=0.2, it=3):
    """Robust locally-weighted linear regression (LOWESS).

    Tricube distance weights over a bandwidth of ``frac`` of the data,
    ``it`` robustifying iterations with bisquare residual weights. Matches
    statsmodels' lowess output closely on smooth binned data (the only use
    here is the 101-bin GC curve).
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    n = len(x)
    r = max(int(np.ceil(frac * n)), 2)

    delta = np.ones(n)
    smoothed = np.zeros(n)
    for _ in range(it + 1):
        for i in range(n):
            dist = np.abs(x - x[i])
            idx = np.argsort(dist)[:r]
            dmax = dist[idx].max()
            if dmax == 0:
                smoothed[i] = np.average(y[idx], weights=delta[idx] + 1e-12)
                continue
            w = (1 - (dist[idx] / dmax) ** 3) ** 3
            w = np.clip(w, 0, None) * delta[idx]
            if w.sum() <= 0:
                smoothed[i] = y[i]
                continue
            xw = x[idx]
            # weighted linear fit evaluated at x[i]
            wsum = w.sum()
            xm = (w * xw).sum() / wsum
            ym = (w * y[idx]).sum() / wsum
            cov = (w * (xw - xm) * (y[idx] - ym)).sum()
            var = (w * (xw - xm) ** 2).sum()
            beta = cov / var if var > 0 else 0.0
            smoothed[i] = ym + beta * (x[i] - xm)

        resid = y - smoothed
        s = np.median(np.abs(resid))
        if s <= 0:
            break
        delta = np.clip(resid / (6.0 * s), -1, 1)
        delta = (1 - delta ** 2) ** 2

    return smoothed


class _GenomeCoords(object):
    """Concatenated-genome coordinate frame over an ordered chromosome set.

    Sampled positions live on the concatenation; helpers split a sorted
    position vector per chromosome and map back to (chromosome, offset).
    """

    def __init__(self, chromosome_lengths):
        self.names = list(chromosome_lengths.keys())
        lengths = np.array([chromosome_lengths[c] for c in self.names],
                           dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(lengths)])
        self.total = int(self.offsets[-1])

    def local_slice(self, sorted_positions, chromosome):
        """(global index slice, chromosome-local positions) of the sorted
        positions falling on one chromosome."""
        i = self.names.index(chromosome)
        lo, hi = np.searchsorted(sorted_positions,
                                 [self.offsets[i], self.offsets[i + 1]])
        return slice(lo, hi), sorted_positions[lo:hi] - self.offsets[i]

    def split(self, sorted_positions):
        """(chromosome name array, local position array)."""
        which = np.searchsorted(self.offsets[1:], sorted_positions,
                                side='right')
        names = np.asarray(self.names, dtype=object)[which]
        return names, sorted_positions - self.offsets[which]


# ---------------------------------------------------------------------------
# Reference sequence and mappability
# ---------------------------------------------------------------------------

def _read_fai(fai_filename):
    """[(name, length, offset, line bases, line width)] of a .fai."""
    records = []
    with open(fai_filename) as f:
        for line in f:
            fields = line.rstrip('\n').split('\t')
            if len(fields) >= 5:
                records.append((fields[0],) + tuple(int(v)
                                                    for v in fields[1:5]))
    return records


def fasta_records(fasta_filename, chromosomes):
    """Yield (name, bases) of the FASTA's records named in ``chromosomes``,
    in file order, ``bases`` a uint8 array of the sequence's bytes. With a
    ``.fai`` beside the FASTA each record is read by seeking to it."""
    fai_filename = fasta_filename + '.fai'
    if not os.path.exists(fai_filename):
        for name, sequence in read_sequences(fasta_filename):
            if name in chromosomes:
                yield name, np.frombuffer(sequence.encode(), dtype=np.uint8)
        return
    with open(fasta_filename, 'rb') as fasta:
        for name, length, offset, line_bases, line_width in _read_fai(
                fai_filename):
            if name not in chromosomes:
                continue
            fasta.seek(offset)
            full, rest = divmod(length, line_bases)
            raw = fasta.read(full * line_width + rest)
            bases = np.frombuffer(raw.translate(None, b'\r\n'),
                                  dtype=np.uint8)
            if len(bases) != length:
                raise ValueError('{}: record {} has {} bases, its index '
                                 '{}'.format(fasta_filename, name,
                                             len(bases), length))
            yield name, bases


def _is_gc(bases):
    return ((bases == ord('G')) | (bases == ord('C'))
            | (bases == ord('g')) | (bases == ord('c')))


def read_mappability_indicator(mappability_filename, chromosome,
                               max_chromosome_length, map_qual_threshold):
    """Per-position 0/1 mappability of one chromosome: covered by a
    mappability interval of quality at least ``map_qual_threshold``."""
    if is_hdf5(mappability_filename):
        import h5py
        with h5py.File(mappability_filename, 'r') as store:
            group = store['chromosome_' + chromosome]
            start = group['start'][()]
            end = group['end'][()]
            quality = group['quality'][()]
    else:
        path = os.path.join(mappability_filename,
                            'chromosome_' + chromosome)
        start, end, quality = (np.load(os.path.join(path, name + '.npy'))
                               for name in ('start', 'end', 'quality'))

    keep = quality >= map_qual_threshold
    # difference-array interval fill: +1 at starts, -1 at ends, positive
    # running sum marks covered positions
    delta = np.zeros(max_chromosome_length + 1, dtype=np.int32)
    np.add.at(delta, np.minimum(start[keep], max_chromosome_length), 1)
    np.add.at(delta, np.minimum(end[keep], max_chromosome_length), -1)
    return (np.cumsum(delta[:-1]) > 0).astype(np.uint8)


def read_gc_cumsum(genome_fasta, chromosome):
    """GC cumulative sum (int64) over one chromosome's sequence; None when
    the FASTA has no such record."""
    gc_cumsum = None
    for _, bases in fasta_records(genome_fasta, {chromosome}):
        gc_cumsum = _is_gc(bases).astype(np.int64).cumsum()
    return gc_cumsum


# ---------------------------------------------------------------------------
# GC sampling and the GC curve
# ---------------------------------------------------------------------------

def _window_gc_fractions(bases, positions, fragment_length,
                         position_offset):
    """GC fraction of each sampled fragment's trimmed window
    [pos + offset, pos + fragment_length - offset); NaN for fragments
    running past the chromosome end."""
    cumsum = np.concatenate([[0], np.cumsum(_is_gc(bases))]).astype(float)

    window = fragment_length - 2 * position_offset
    hi = positions + fragment_length - position_offset
    lo = hi - window
    in_range = hi <= len(bases)
    counts = np.full(positions.shape, np.nan)
    counts[in_range] = (cumsum[hi[in_range]] - cumsum[lo[in_range]])
    return counts / float(window)


def _accumulate_matching_counts(accumulator, sorted_positions, starts):
    """Add, per sampled position, how many ``starts`` equal it."""
    unique_starts, start_counts = np.unique(starts, return_counts=True)
    hit = np.searchsorted(unique_starts, sorted_positions)
    matched = (hit < len(unique_starts)) \
        & (unique_starts[np.minimum(hit, len(unique_starts) - 1)]
           == sorted_positions)
    accumulator[matched] += start_counts[hit[matched]]


def sample_gc(gc_samples_filename, seqdata_filename, fragment_length, config,
              ref_data_dir, rng=None):
    """Random-position GC and read-start table (no header: chromosome,
    position, GC fraction, read starts there).

    Draws ``sample_gc_num_positions`` positions uniformly over the
    concatenated configured genome from ``rng`` (a
    ``numpy.random.RandomState``; by default numpy's global state, which
    the JAX package draws from), keeps those whose fragment-sized window
    lies inside its chromosome and is mappable, and counts the fragments
    starting at each.
    """
    rng = np.random if rng is None else rng
    chromosomes = remixt_tpu_torch.config.get_chromosomes(config,
                                                          ref_data_dir)
    coords = _GenomeCoords(remixt_tpu_torch.config.get_chromosome_lengths(
        config, ref_data_dir))
    fragment_length = int(fragment_length)
    position_offset = _param(config, 'gc_position_offset')
    mappability_filename = _ref_file(config, ref_data_dir, 'mappability')
    map_qual_threshold = _param(config, 'map_qual_threshold')

    positions = np.sort(rng.randint(
        0, coords.total, _param(config, 'sample_gc_num_positions')))

    gc_fraction = np.full(positions.shape, np.nan)
    mappable = np.ones(positions.shape)
    for chrom_id, bases in fasta_records(
            _ref_file(config, ref_data_dir, 'genome_fasta'),
            set(chromosomes)):
        window, local = coords.local_slice(positions, chrom_id)
        gc_fraction[window] = _window_gc_fractions(
            bases, local, fragment_length, position_offset)
        indicator = read_mappability_indicator(
            mappability_filename, chrom_id, len(bases), map_qual_threshold)
        mappable[window] *= indicator[local]

    keep = (mappable > 0) & ~np.isnan(gc_fraction)
    positions = positions[keep]
    gc_fraction = gc_fraction[keep]

    read_count = np.zeros(positions.shape, dtype=np.int64)
    for chrom_id in seqdataio.read_chromosomes(seqdata_filename):
        if chrom_id not in chromosomes:
            continue
        window, local = coords.local_slice(positions, chrom_id)
        for chunk in seqdataio.read_fragment_data(
                seqdata_filename, chrom_id,
                filter_duplicates=_param(config, 'filter_duplicates'),
                map_qual_threshold=map_qual_threshold,
                chunksize=1000000):
            _accumulate_matching_counts(
                read_count[window], local, chunk['start'])

    names, local = coords.split(positions)
    write_tsv(Table([
        ('chromosome', names),
        ('position', local),
        ('gc_percent', gc_fraction),
        ('read_count', read_count),
    ]), gc_samples_filename, header=False)


def gc_lowess(gc_samples_filename, gc_dist_filename, gc_table_filename,
              gc_resolution=100):
    """LOWESS read-rate-vs-GC curve from the sampled-position table: the
    per-bin mean read count over ``gc_resolution + 1`` GC bins, smoothed
    and rescaled to unit maximum."""
    samples = np.loadtxt(gc_samples_filename, delimiter='\t',
                         usecols=(2, 3), dtype=float, ndmin=2)

    num_bins = gc_resolution + 1
    bin_of = np.round(samples[:, 0] * gc_resolution).astype(int)
    occupancy = np.bincount(bin_of, minlength=num_bins).astype(float)
    totals = np.bincount(bin_of, weights=samples[:, 1], minlength=num_bins)
    with np.errstate(invalid='ignore'):
        means = np.where(occupancy > 0, totals / occupancy, 0.0)

    gc_bin = np.arange(num_bins, dtype=float)
    smoothed = lowess(means, gc_bin, frac=0.2)
    assert not np.isnan(smoothed).any()

    peak = smoothed.max()
    write_tsv(Table([('gc_bin', gc_bin), ('sum', totals),
                     ('len', occupancy), ('mean', means / peak),
                     ('smoothed', smoothed / peak)]), gc_table_filename)
    write_tsv(Table([('smoothed', smoothed / peak)]), gc_dist_filename,
              header=False)


class GCCurve(object):
    """Normalized GC weight curve with vectorized window tables.

    ``table(l)`` returns curve weights for every GC count 0..l of an
    l-wide window, by one vectorized index computation (the reference
    evaluates a scalar ``predict`` per count, gcbias.py:193-215).
    """

    def read(self, gc_dist_filename):
        values = np.loadtxt(gc_dist_filename, dtype=float, ndmin=1)
        self.gc_lowess = values / values.sum()
        self.cache = {}

    def predict(self, x):
        bins = len(self.gc_lowess)
        idx = min(max(int(x * (bins - 1)), 0), bins - 1)
        return max(self.gc_lowess[idx], 0.0)

    def table(self, l):
        if l not in self.cache:
            bins = len(self.gc_lowess)
            # same float truncation as predict (k/l evaluated in float)
            idx = np.clip(((np.arange(l + 1) / float(l))
                           * (bins - 1)).astype(int), 0, bins - 1)
            self.cache[l] = np.maximum(self.gc_lowess[idx], 0.0)
        return self.cache[l]


# ---------------------------------------------------------------------------
# Per-segment bias and biased length
# ---------------------------------------------------------------------------

def gc_map_bias(segment_filename, fragment_mean, fragment_stddev,
                gc_dist_filename, bias_filename, config, ref_data_dir):
    """Per-segment GC and mappability bias task: the segment table with a
    ``bias`` column."""
    segments = read_tsv(segment_filename, str_columns=('chromosome',))
    write_tsv(calculate_gc_map_bias(
        segments, fragment_mean, fragment_stddev, gc_dist_filename, config,
        ref_data_dir), bias_filename)


def calculate_gc_map_bias(segments, fragment_mean, fragment_stddev,
                          gc_dist_filename, config, ref_data_dir):
    """Expected read-generation bias per segment: the fragment-length
    distribution truncated to its central 98 % and stepped by 10, each
    segment integrating per-position generation probabilities over it, one
    chromosome (in order of first appearance) and one segment at a time.
    Returns the segments with a ``bias`` column."""
    gc_curve = GCCurve()
    gc_curve.read(gc_dist_filename)

    length_dist = scipy.stats.norm(fragment_mean, fragment_stddev)
    length_lo = int(length_dist.ppf(0.01) - 1.)
    length_hi = int(length_dist.ppf(0.99) + 1.)

    mappability_filename = _ref_file(config, ref_data_dir, 'mappability')
    bias = np.full(len(segments), np.nan)
    chromosomes = segments['chromosome']
    for chromosome in dict.fromkeys(chromosomes.tolist()):
        gc_cumsum = read_gc_cumsum(
            _ref_file(config, ref_data_dir, 'genome_fasta'), chromosome)
        mappability = read_mappability_indicator(
            mappability_filename, chromosome, gc_cumsum.shape[0],
            _param(config, 'map_qual_threshold'))

        for idx in np.flatnonzero(chromosomes == chromosome):
            start, end = segments['start'][idx], segments['end'][idx]
            bias[idx] = calculate_segment_gc_map_bias(
                gc_cumsum[start:end], mappability[start:end],
                gc_curve, length_dist, length_lo, length_hi, 10,
                _param(config, 'gc_position_offset'),
                _param(config, 'mappability_length'),
                do_gc=_param(config, 'do_gc_correction'),
                do_map=_param(config, 'do_mappability_correction'))

    biased = Table(list(segments.items()))
    biased['bias'] = bias
    return biased


def _fragment_start_probabilities(gc_cumsum, mappability, gc_dist,
                                  fragment_length, position_offset,
                                  read_length, do_gc, do_map):
    """Per-start-position generation probability for one fragment length:
    GC-curve weight of the trimmed fragment window times the mappability of
    both read placements."""
    n_starts = gc_cumsum.shape[0] - fragment_length
    prob = np.ones(n_starts)

    if do_gc:
        window = fragment_length - 2 * position_offset
        window_gc = (
            gc_cumsum[fragment_length - position_offset:-position_offset]
            - gc_cumsum[position_offset:-fragment_length + position_offset])
        prob = prob * gc_dist.table(window)[window_gc]

    if do_map:
        mate_offset = fragment_length - read_length
        prob = prob * (mappability[:-fragment_length]
                       * mappability[mate_offset:-read_length])

    return prob


def calculate_segment_gc_map_bias(gc_cumsum, mappability, gc_dist,
                                  fragment_dist, fragment_min, fragment_max,
                                  fragment_step, position_offset, read_length,
                                  do_gc=True, do_map=True):
    """Expected read-generation bias of one segment: the integral over the
    fragment-length distribution of summed per-position probabilities
    (parity: reference gcbias.py:262-302)."""
    bias = 0.
    for fragment_length in range(fragment_min, fragment_max + 1,
                                 fragment_step):
        if fragment_length < read_length or (
                fragment_length >= gc_cumsum.shape[0]):
            continue
        start_probs = _fragment_start_probabilities(
            gc_cumsum, mappability, gc_dist, fragment_length,
            position_offset, read_length, do_gc, do_map)
        bias += fragment_dist.pdf(fragment_length) * start_probs.sum()
    return bias


def calculate_biased_length(segments):
    """Rescale segment length by the normalized bias, in place."""
    segments['bias'] = segments['bias'] / segments['bias'].sum()
    segments['length'] = segments['bias'] * float(
        (segments['end'] - segments['start']).sum())
    return segments


def biased_length(length_filename, bias_filename):
    """Biased segment length task: the bias table with ``length``."""
    segments = read_tsv(bias_filename, str_columns=('chromosome',))
    write_tsv(calculate_biased_length(segments), length_filename)
