"""Segmentation and segment read counting (numpy).

Counterpart of ``remixt_tpu/analysis/segment.py``: a regular-grid
segmentation with assembly-gap boundaries and predicted breakends, the
dropping of segments that start in a gap and of unconfigured chromosomes,
fragment counting by interval containment, and the merge of phased
allele counts into the segment count table.
"""

import csv
import gzip

import numpy as np

import remixt_tpu_torch.config
from remixt_tpu_torch import segalg, seqdataio
from remixt_tpu_torch.io.table import Table, read_tsv, write_tsv

GAP_TABLE_COLUMNS = [
    'bin', 'chromosome', 'start', 'end', 'ix', 'n', 'size', 'type', 'bridge',
]


def _check_chr_prefix(names, chr_name_prefix):
    prefixed = [str(c).startswith('chr') for c in names]
    if chr_name_prefix == 'chr':
        assert all(prefixed)
    elif chr_name_prefix == '':
        assert not any(prefixed)
    else:
        raise ValueError(
            'unrecognized chr_name_prefix {}'.format(chr_name_prefix))


def read_gap_table(gap_table_filename):
    """The gzipped UCSC gap table (no header) as a Table of chromosome,
    start and end."""
    chromosome, start, end = [], [], []
    with gzip.open(gap_table_filename, 'rt', newline='') as f:
        for row in csv.reader(f, delimiter='\t'):
            if row:
                chromosome.append(row[1])
                start.append(int(row[2]))
                end.append(int(row[3]))
    return Table([('chromosome', np.array(chromosome, dtype=object)),
                  ('start', np.array(start, dtype=np.int64)),
                  ('end', np.array(end, dtype=np.int64))])


def _merge_intervals(starts, ends):
    """Union of possibly-overlapping [start, end) intervals, as two sorted
    arrays (classic sort + running-max sweep)."""
    order = np.argsort(starts, kind='stable')
    starts, ends = starts[order], np.maximum.accumulate(ends[order])
    new_run = np.concatenate(([True], starts[1:] > ends[:-1]))
    merged_starts = starts[new_run]
    merged_ends = np.maximum.reduceat(ends, np.flatnonzero(new_run))
    return merged_starts, merged_ends


def assemble_changepoints(chromosomes, chromosome_lengths, segment_length,
                          gap_table, breakpoints=None):
    """All changepoint (chromosome, position) pairs: the regular grid with
    each chromosome's end, the gap boundaries and the breakend positions,
    as two arrays."""
    names, positions = [], []
    for chromosome in chromosomes:
        length = int(chromosome_lengths[chromosome])
        grid = np.arange(0, length, segment_length, dtype=np.int64)
        positions.append(np.concatenate([grid, [length]]))
        names += [chromosome] * len(positions[-1])

    names += np.repeat(gap_table['chromosome'], 2).tolist()
    positions.append(np.stack([gap_table['start'], gap_table['end']],
                              axis=1).reshape(-1))

    if breakpoints is not None:
        names += list(breakpoints['chromosome_1']) + list(
            breakpoints['chromosome_2'])
        positions += [breakpoints['position_1'], breakpoints['position_2']]

    return (np.array(names, dtype=object),
            np.concatenate(positions).astype(np.int64))


def create_segments(segment_filename, config, ref_data_dir,
                    breakpoint_filename=None):
    """Write the segmentation TSV (regular grid, gaps, breakends)."""
    get = lambda name: remixt_tpu_torch.config.get_param(config, name)
    segment_length = get('segment_length')
    chromosome_lengths = remixt_tpu_torch.config.get_chromosome_lengths(
        config, ref_data_dir)
    chromosomes = list(chromosome_lengths)
    chr_name_prefix = get('chr_name_prefix')

    gap_table = read_gap_table(remixt_tpu_torch.config.get_filename(
        config, ref_data_dir, 'gap_table'))
    _check_chr_prefix(gap_table['chromosome'], chr_name_prefix)

    breakpoints = None
    if breakpoint_filename is not None:
        breakpoints = read_tsv(breakpoint_filename,
                               str_columns=('chromosome_1', 'chromosome_2'))
        for side in ('1', '2'):
            _check_chr_prefix(breakpoints['chromosome_' + side],
                              chr_name_prefix)

    names, positions = assemble_changepoints(
        chromosomes, chromosome_lengths, segment_length, gap_table,
        breakpoints)

    # pair successive changepoints within each chromosome, sorted by
    # chromosome name and position (stable)
    order = sorted(range(len(names)), key=lambda i: (names[i], positions[i]))
    names, positions = names[order], positions[order]
    same_chrom = names[:-1] == names[1:]
    seg_chrom = names[:-1][same_chrom]
    seg_start = positions[:-1][same_chrom]
    seg_end = positions[1:][same_chrom]
    keep = seg_start < seg_end
    seg_chrom, seg_start, seg_end = (seg_chrom[keep], seg_start[keep],
                                     seg_end[keep])

    # drop segments starting inside an assembly gap
    in_gap = np.zeros(len(seg_chrom), dtype=bool)
    for chromosome in sorted(set(gap_table['chromosome'])):
        on_chrom = seg_chrom == chromosome
        if not on_chrom.any():
            continue
        gaps = gap_table['chromosome'] == chromosome
        gap_starts, gap_ends = _merge_intervals(gap_table['start'][gaps],
                                                gap_table['end'][gaps])
        owner = segalg.find_contained_positions(
            np.stack([gap_starts, gap_ends], axis=1), seg_start[on_chrom])
        in_gap[on_chrom] = owner >= 0

    # keep only configured chromosomes, ordered by the configured list then
    # position
    chrom_rank = {c: i for i, c in enumerate(chromosomes)}
    keep = ~in_gap & np.array([c in chrom_rank for c in seg_chrom],
                              dtype=bool)
    seg_chrom, seg_start, seg_end = (seg_chrom[keep], seg_start[keep],
                                     seg_end[keep])
    order = np.lexsort((seg_start, [chrom_rank[c] for c in seg_chrom]))
    write_tsv(Table([('chromosome', seg_chrom[order]),
                     ('start', seg_start[order]),
                     ('end', seg_end[order])]), segment_filename)


def count_segment_reads(seqdata_filename, chromosome, starts, ends,
                        filter_duplicates=False, map_qual_threshold=1):
    """Fragments fully contained in each of one chromosome's segments
    (float counts, in the segments' order)."""
    reads = seqdataio.read_fragment_data(
        seqdata_filename, chromosome,
        filter_duplicates=filter_duplicates,
        map_qual_threshold=map_qual_threshold)
    order = np.argsort(starts, kind='stable')
    counts = segalg.contained_counts(
        np.stack([starts[order], ends[order]], axis=1),
        np.stack([reads['start'], reads['end']], axis=1))
    out = np.empty(len(starts))
    out[order] = counts
    return out


def create_segment_counts(segments, seqdata_filename, filter_duplicates=False,
                          map_qual_threshold=1):
    """The segment Table with a ``readcount`` column: fragment counts per
    segment, chromosome by chromosome."""
    readcount = np.zeros(len(segments))
    for chromosome in sorted(set(segments['chromosome'])):
        rows = np.flatnonzero(segments['chromosome'] == chromosome)
        readcount[rows] = count_segment_reads(
            seqdata_filename, chromosome, segments['start'][rows],
            segments['end'][rows], filter_duplicates=filter_duplicates,
            map_qual_threshold=map_qual_threshold)
    counted = Table(list(segments.items()))
    counted['readcount'] = readcount
    return counted


def create_segment_allele_counts(segment_data, allele_data):
    """Merge phased block allele counts into the segment counts, deriving
    the allele a/b, major/minor columns and the phase indicator."""
    keys = list(zip(segment_data['chromosome'], segment_data['start'],
                    segment_data['end']))
    row_of = {key: i for i, key in enumerate(keys)}
    per_allele = np.zeros((len(keys), 2), dtype=np.int64)
    for chrom, start, end, is_a, count in zip(
            allele_data['chromosome'], allele_data['start'],
            allele_data['end'], allele_data['is_allele_a'],
            allele_data['readcount']):
        row = row_of.get((chrom, start, end))
        if row is not None:
            per_allele[row, int(is_a)] += count
    b, a = per_allele[:, 0], per_allele[:, 1]

    counts = Table(list(segment_data.items()))
    counts['allele_b_readcount'] = b
    counts['allele_a_readcount'] = a
    counts['major_readcount'] = np.maximum(a, b)
    counts['minor_readcount'] = np.minimum(a, b)
    counts['major_is_allele_a'] = (a >= b).astype(np.int64)
    return counts
