"""THetA2 wrapper: input preparation, execution, result conversion
(counterpart of ``remixt_tpu/wrappers/wraptheta.py``).

The input writers and the result parser stand alone; :func:`run` shells
out to the THetA binary and to octave's BAF model.

THetA's inputs:
  * an interval-count table, headerless TSV: segment_id, chrom_idx,
    start, end, tumour_count, normal_count, upper_bound, lower_bound;
  * allele-count tables (chrom_idx, position, A, C, T, G, total,
    ref_count, alt_count, the nucleotide columns zero).
THetA's output: a ``*.BAF.NLL.results`` TSV whose best row (least
NLL + BAF_NLL) holds the mixture ``mu`` (comma-separated) and each
interval's clone copy numbers ``C`` (colon-separated intervals of
comma-separated clones).
"""

import os
import subprocess

import numpy as np

from remixt_tpu_torch.io.table import Table, read_tsv, write_tsv
from remixt_tpu_torch.wrappers import formats
from remixt_tpu_torch.wrappers.wraptitan import write_mix

INTERVAL_COLUMNS = ['segment_id', 'chrom_idx', 'start', 'end',
                    'count_tumour', 'count_normal',
                    'upper_bound', 'lower_bound']


def chromosome_index(chromosomes):
    """Stable chromosome -> integer index mapping used across all inputs."""
    return {c: i for i, c in enumerate(chromosomes)}


def _map(values, mapping):
    """``Series.map(dict)``: an int64 column where every value maps, else
    float64 with NaN where one does not."""
    mapped = [mapping.get(v) for v in values.tolist()]
    if any(m is None for m in mapped):
        return np.array([np.nan if m is None else m for m in mapped],
                        dtype=np.float64)
    return np.array(mapped, dtype=np.int64)


def write_interval_counts(filename, segments, normal_seqdata, tumour_seqdata,
                          max_copy_number=5):
    """The THetA interval-count file over an explicit segmentation (a
    Table of chromosome, start and end). Returns the chromosome-index
    mapping for the other files."""
    normal = formats.segment_read_counts(normal_seqdata, segments)
    tumour = formats.segment_read_counts(tumour_seqdata, segments)

    chrom_idx = chromosome_index(dict.fromkeys(
        segments['chromosome'].tolist()))
    n = len(segments)
    write_tsv(Table([
        ('segment_id', np.arange(n)),
        ('chrom_idx', _map(segments['chromosome'], chrom_idx)),
        ('start', segments['start']),
        ('end', segments['end']),
        ('count_tumour', tumour['count'].astype(np.int64)),
        ('count_normal', normal['count'].astype(np.int64)),
        ('upper_bound', np.full(n, max_copy_number)),
        ('lower_bound', np.zeros(n, dtype=np.int64)),
    ]), filename, header=False)
    return chrom_idx


def write_alleles(filename, het_counts, chrom_idx):
    """THetA2's runBAFGaussianModel reads the columns by position:
    chrom_idx, position, the A/C/T/G counts (unused, written as zeros),
    total, ref_count, alt_count."""
    ref = het_counts['ref_count'].astype(np.int64)
    alt = het_counts['alt_count'].astype(np.int64)
    zeros = np.zeros(len(het_counts), dtype=np.int64)
    write_tsv(Table([
        ('chrom_idx', _map(het_counts['chromosome'], chrom_idx)),
        ('position', het_counts['position']),
        ('A', zeros), ('C', zeros), ('T', zeros), ('G', zeros),
        ('total', ref + alt),
        ('ref_count', ref),
        ('alt_count', alt),
    ]), filename, header=False)


def prepare_inputs(analysis_dir, normal_seqdata, tumour_seqdata, segments,
                   max_copy_number=5):
    os.makedirs(analysis_dir, exist_ok=True)
    paths = {
        'counts': os.path.join(analysis_dir, 'counts.tsv'),
        'normal_alleles': os.path.join(analysis_dir, 'normal_alleles.tsv'),
        'tumour_alleles': os.path.join(analysis_dir, 'tumour_alleles.tsv'),
    }
    chrom_idx = write_interval_counts(
        paths['counts'], segments, normal_seqdata, tumour_seqdata,
        max_copy_number)
    het = formats.het_tumour_allele_counts(normal_seqdata, tumour_seqdata)
    write_alleles(paths['tumour_alleles'], het, chrom_idx)
    het_normal = formats.het_tumour_allele_counts(
        normal_seqdata, normal_seqdata)
    write_alleles(paths['normal_alleles'], het_normal, chrom_idx)
    paths['chrom_idx'] = chrom_idx
    return paths


def read_interval_counts(counts_filename):
    return read_tsv(counts_filename, names=INTERVAL_COLUMNS)


def run(analysis_dir, theta_bin, octave_bin_directory, num_intervals=15):
    """THetA, then octave's BAF model, on the inputs in analysis_dir."""
    counts = os.path.join(analysis_dir, 'counts.tsv')
    prefix = os.path.join(analysis_dir, 'theta')
    subprocess.check_call([
        theta_bin, counts, '--FORCE',
        '--NUM_INTERVALS', str(num_intervals),
        '--OUTPUT_PREFIX', prefix,
    ])
    chrom_ids = sorted(set(read_interval_counts(counts)['chrom_idx']
                           .tolist()))
    args = ", ".join([
        "'{}'".format(os.path.join(analysis_dir, 'tumour_alleles.tsv')),
        "'{}'".format(os.path.join(analysis_dir, 'normal_alleles.tsv')),
        "'{}'".format(counts),
        "'{}'".format(prefix + '.n3.results'),
        '[' + ','.join(map(str, chrom_ids)) + ']',
        "'{}'".format(os.path.join(analysis_dir, 'theta2')),
        '[11,8]',
        "'none'",
    ])
    subprocess.check_call(
        'octave --eval "cd {}; runBAFGaussianModel({})"'.format(
            octave_bin_directory, args),
        shell=True)


def parse_results(results_filename, counts_filename, chrom_names):
    """The best THetA2 solution as (standard cn Table, mixture list).

    chrom_names: index -> chromosome name (the inverse of
    chromosome_index).
    """
    results = read_tsv(results_filename)
    nll = results['#NLL'] if '#NLL' in results else results['NLL']
    best = int(np.nanargmin(nll + results['BAF_NLL']))

    mix = [float(v) for v in str(results['mu'][best]).split(',')]

    per_interval = np.array(
        [entry.split(',') for entry in str(results['C'][best]).split(':')],
        dtype=int)                                    # (intervals, clones)

    counts = read_interval_counts(counts_filename)
    table = Table([
        ('chromosome', np.array([chrom_names.get(i) for i in
                                 counts['chrom_idx'].tolist()],
                                dtype=object)),
        ('start', counts['start']),
        ('end', counts['end']),
        ('total_1', per_interval[:, 0]),
        ('total_2', per_interval[:, 1] if per_interval.shape[1] > 1
         else per_interval[:, 0]),
    ])
    return table, mix


def report(analysis_dir, output_cn_filename, output_mix_filename,
           chrom_names):
    table, mix = parse_results(
        os.path.join(analysis_dir, 'theta2.BAF.NLL.results'),
        os.path.join(analysis_dir, 'counts.tsv'),
        chrom_names)
    write_mix(output_mix_filename, mix)
    write_tsv(table, output_cn_filename)
