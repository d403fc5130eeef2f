"""Read-level simulation: fragments on rearranged genomes, SNP reads (numpy).

Counterpart of ``remixt_tpu/simulations/seqread.py`` without pandas:
fragment intervals drawn on the concatenated rearranged genome and remapped
to reference coordinates, SNP reads with base-call errors, and resampling
of real reads to simulated per-segment depths, written as seqdata through
``seqdataio.Writer`` (an HDF5 file for a name ending in ``.h5``, else a
directory of ``.npy`` columns).

Every function that draws takes ``rng`` (a ``np.random.RandomState``;
numpy's global state by default) and draws exactly where the JAX package
draws from numpy's global generator, with the same calls, so the same seed
gives the same seqdata row for row. The JAX package's pandas sets the row
and draw order: chromosomes are visited in sorted string order ('10' <
'2'), within every chunk of ``chunk_cap`` fragments, and fragments keep
their order within a chromosome.
"""

import collections

import numpy as np

from remixt_tpu_torch import segalg, seqdataio
from remixt_tpu_torch.io.table import Table

# fragments drawn at a time on one genome
CHUNK_CAP = 40000000


def segment_remap(segments, positions):
    """Map positions on the concatenation of ``segments`` back into the
    segments' own coordinates.

    Returns (segment index, remapped position) per input position.
    """
    lengths = segments[:, 1] - segments[:, 0]
    boundaries = np.cumsum(lengths)
    total = boundaries[-1] if len(boundaries) else 0
    if np.any(positions > total):
        raise ValueError('positions should be less than total segment length')

    which = np.searchsorted(boundaries, positions, side='right')
    offset = positions - (boundaries[which] - lengths[which])
    return which, segments[which, 0] + offset


def simulate_fragment_intervals(genome_length, num_fragments, read_length,
                                fragment_mean, fragment_stddev, rng=None):
    """Fragment (start, length) draws: uniform starts, normal lengths,
    dropping fragments shorter than a read or running off the genome."""
    rng = np.random if rng is None else rng
    starts = np.sort(rng.randint(0, high=genome_length, size=num_fragments))
    lengths = np.asarray(
        rng.randn(num_fragments) * fragment_stddev + fragment_mean,
        dtype=int)
    keep = (lengths >= read_length) & (starts + lengths < genome_length)
    return starts[keep], lengths[keep]


def _signed_segment_table(genome):
    """Segment copies in rearranged order, reverse-orientation copies with
    negated, swapped coordinates, so one remap handles both orientations
    (the unflip happens in `_map_fragments_to_reference`)."""
    table = genome.segment_copy_table()
    reverse = table['orientation'] != 1
    start, end = table['start'].copy(), table['end'].copy()
    start[reverse] = -table['end'][reverse]
    end[reverse] = -table['start'][reverse]
    table['start'], table['end'] = start, end
    return table


def _map_fragments_to_reference(segment_table, starts, lengths):
    """Reference-coordinate fragments from concatenated-genome draws.

    Both fragment ends remap through the signed segment table; fragments
    whose ends land in different segment copies are dropped, and
    fragments on reversed copies are flipped back to forward reference
    coordinates. Returns (segment-copy index, start, end, allele).
    """
    coords = np.stack([segment_table['start'], segment_table['end']], axis=1)
    seg_of_end, ref_end = segment_remap(coords, starts + lengths)
    seg_of_start, ref_start = segment_remap(coords, starts)

    within_one_segment = ref_end - ref_start == lengths
    seg_idx = seg_of_start[within_one_segment]
    ref_start = ref_start[within_one_segment]
    lengths = lengths[within_one_segment]

    # signed (reversed) copies produced negative coordinates
    ref_start = np.where(ref_start < 0, -ref_start - lengths, ref_start)
    return (seg_idx, ref_start, ref_start + lengths,
            segment_table['allele'][seg_idx])


def _interval_position_overlap(intervals, positions):
    """``segalg.interval_position_overlap``, which fails on no intervals
    (a chromosome whose fragments were all drawn zero times), also for
    none."""
    if len(intervals) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    return segalg.interval_position_overlap(intervals, positions)


def _overlap_snps(fragments, chrom_snps, read_length, base_call_error, rng):
    """Allele observations: SNPs under either sequenced read end of each
    fragment, read from the fragment's germline allele with base-call
    errors flipped in. Returns a table of fragment_id, position, is_alt."""
    frag_idx, snp_idx = _interval_position_overlap(
        np.stack([fragments['start'], fragments['end']], axis=1),
        chrom_snps['position'])
    position = chrom_snps['position'][snp_idx]
    under_read = (
        (position < fragments['start'][frag_idx] + read_length)
        | (position >= fragments['end'][frag_idx] - read_length))
    frag_idx, snp_idx = frag_idx[under_read], snp_idx[under_read]

    germline = np.where(fragments['allele'][frag_idx] == 0,
                        chrom_snps['is_alt_0'][snp_idx],
                        chrom_snps['is_alt_1'][snp_idx])
    miscalled = rng.choice(
        [True, False], size=len(frag_idx),
        p=[base_call_error, 1. - base_call_error])
    return Table([('fragment_id', fragments['fragment_id'][frag_idx]),
                  ('position', position[under_read]),
                  ('is_alt', np.where(miscalled, 1 - germline, germline))])


class _FragmentIds:
    """Per-chromosome monotone fragment ids across write calls."""

    def __init__(self):
        self._next = collections.Counter()

    def assign(self, chromosome, n):
        ids = np.arange(n) + self._next[chromosome]
        self._next[chromosome] += n
        return ids


def _emit_chromosome(writer, ids, chromosome, start, end, allele, snps,
                     params, rng):
    """Assign ids, intersect SNPs, and write one chromosome's fragments;
    returns their number."""
    fragments = Table([('fragment_id', ids.assign(chromosome, len(start))),
                       ('start', start), ('end', end), ('allele', allele)])
    observations = _overlap_snps(
        fragments, snps['/chromosome_{}'.format(chromosome)],
        params['read_length'], params['base_call_error'], rng)
    writer.write(chromosome, fragments, observations)
    return len(start)


def _by_chromosome(names, codes):
    """(name, row positions) of each chromosome present in ``codes``
    (indexes into ``names``, which are sorted as strings), in that order,
    the rows in their order (pandas' groupby)."""
    order = np.argsort(codes, kind='stable')
    counts = np.bincount(codes, minlength=len(names))
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return [(str(name), order[bounds[k]:bounds[k + 1]])
            for k, name in enumerate(names) if counts[k]]


def simulate_mixture_read_data(read_data_filename, genomes, read_depths,
                               snps, params, rng=None,
                               chunk_cap=CHUNK_CAP):
    """Simulated seqdata for a mixture of rearranged genomes.

    Each genome contributes ``haploid depth × rearranged length``
    fragments, drawn on its concatenated rearranged sequence in chunks of
    at most ``chunk_cap`` and remapped to reference coordinates. ``snps``
    maps '/chromosome_X' to a table of position, is_alt_0 and is_alt_1.
    """
    rng = np.random if rng is None else rng
    writer = seqdataio.Writer(read_data_filename)
    ids = _FragmentIds()
    try:
        for genome, read_depth in zip(genomes, read_depths):
            segment_table = _signed_segment_table(genome)
            rearranged_length = segment_table['length'].sum()
            remaining = int(rearranged_length * read_depth)
            names, copy_codes = np.unique(segment_table['chromosome'],
                                          return_inverse=True)

            while remaining > 0:
                starts, lengths = simulate_fragment_intervals(
                    rearranged_length, min(chunk_cap, remaining),
                    params['read_length'], params['fragment_mean'],
                    params['fragment_stddev'], rng)
                seg_idx, start, end, allele = _map_fragments_to_reference(
                    segment_table, starts, lengths)
                for chromosome, rows in _by_chromosome(
                        names, copy_codes[seg_idx]):
                    remaining -= _emit_chromosome(
                        writer, ids, chromosome, start[rows], end[rows],
                        allele[rows], snps, params, rng)
    finally:
        writer.close()


def kahan_group_sums(values, starts):
    """Sum of each run ``values[starts[k]:starts[k + 1]]`` in row order
    with Kahan compensation, as pandas' groupby sum adds (its
    ``group_sum``), so the sums are pandas' bit for bit."""
    sizes = np.diff(np.append(starts, len(values)))
    sums = np.zeros(len(starts))
    compensation = np.zeros(len(starts))
    for k in range(int(sizes.max()) if len(sizes) else 0):
        live = sizes > k
        val = values[starts[live] + k]
        y = val - compensation[live]
        t = sums[live] + y
        comp = t - sums[live] - y
        compensation[live] = np.where(comp != comp, 0.0, comp)
        sums[live] = t
    return sums


def _mixture_depth_targets(genomes, read_depths):
    """Target read depth per (chromosome, segment, allele): copies in each
    genome times that genome's haploid depth, summed over genomes; rows
    sorted by (chromosome as a string, start, end, allele)."""
    tables = [genome.segment_copy_table() for genome in genomes]
    keys = {name: np.concatenate([t[name] for t in tables])
            for name in ('chromosome', 'start', 'end', 'allele')}
    depth = np.concatenate([np.full(len(t), read_depths[k], dtype=float)
                            for k, t in enumerate(tables)])
    names, codes = np.unique(keys['chromosome'], return_inverse=True)
    order = np.lexsort((keys['allele'], keys['end'], keys['start'], codes))
    sorted_keys = [codes[order], keys['start'][order], keys['end'][order],
                   keys['allele'][order]]
    change = np.zeros(len(order), dtype=bool)
    change[:1] = True
    for column in sorted_keys:
        change[1:] |= column[1:] != column[:-1]
    starts = np.flatnonzero(change)
    first = order[starts]
    targets = Table([
        ('chromosome', names[codes[first]]),
        ('start', keys['start'][first]),
        ('end', keys['end'][first]),
        ('allele', keys['allele'][first]),
        ('read_depth', kahan_group_sums(depth[order], starts)),
    ])
    targets['length'] = targets['end'] - targets['start']
    return targets


def _source_fragments_with_targets(chrom_targets, source_filename,
                                   chromosome):
    """Source fragments joined to their containing segment's target depth,
    in fragment order and, for a segment with both alleles, once per
    allele in target order; fragments contained in no segment drop.
    ``chrom_targets`` are one chromosome's rows of the targets, sorted by
    segment and allele. Returns a table of start, end, allele and
    read_depth."""
    pairs = np.stack([chrom_targets['start'], chrom_targets['end']], axis=1)
    first = np.flatnonzero(np.r_[True, (pairs[1:] != pairs[:-1]).any(axis=1)])
    per_segment = np.diff(np.r_[first, len(pairs)])

    fragments = seqdataio.read_fragment_data(source_filename, chromosome)
    segment_idx = segalg.find_contained_segments(
        pairs[first], np.stack([fragments['start'], fragments['end']], axis=1))
    contained = segment_idx >= 0
    segment_idx = segment_idx[contained]

    per_fragment = per_segment[segment_idx]
    fragment_rows = np.repeat(np.flatnonzero(contained), per_fragment)
    within = np.arange(len(fragment_rows)) - np.repeat(
        np.cumsum(per_fragment) - per_fragment, per_fragment)
    target_rows = np.repeat(first[segment_idx], per_fragment) + within
    return Table([('start', fragments['start'][fragment_rows]),
                  ('end', fragments['end'][fragment_rows]),
                  ('allele', chrom_targets['allele'][target_rows]),
                  ('read_depth', chrom_targets['read_depth'][target_rows])])


def resample_mixture_read_data(read_data_filename, source_filename, genomes,
                               read_depths, snps, params, rng=None):
    """Resample real reads to simulated per-segment depths.

    Every source fragment is drawn a Poisson number of times with rate
    proportional to its segment's target depth, normalized so the total
    expected read count matches the simulated mixture.
    """
    rng = np.random if rng is None else rng
    targets = _mixture_depth_targets(genomes, read_depths)
    wanted_reads = np.sum(targets['length'] * targets['read_depth'])
    chromosomes = _by_chromosome(*np.unique(targets['chromosome'],
                                            return_inverse=True))

    def pool(chromosome, rows):
        return _source_fragments_with_targets(
            targets.take(rows), source_filename, chromosome)

    available_depth = sum(pool(chromosome, rows)['read_depth'].sum()
                          for chromosome, rows in chromosomes)

    writer = seqdataio.Writer(read_data_filename)
    ids = _FragmentIds()
    try:
        for chromosome, rows in chromosomes:
            source = pool(chromosome, rows)
            rate = source['read_depth'] * wanted_reads / available_depth
            draws = rng.poisson(rate)
            _emit_chromosome(
                writer, ids, chromosome,
                *(np.repeat(source[name], draws).astype(int)
                  for name in ('start', 'end', 'allele')),
                snps, params, rng)
    finally:
        writer.close()
