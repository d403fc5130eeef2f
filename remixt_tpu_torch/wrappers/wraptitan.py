"""TITAN wrapper: input preparation, execution, result conversion
(counterpart of ``remixt_tpu/wrappers/wraptitan.py``).

The input writers and the result converter stand alone; only :func:`run`
shells out, to ``Rscript`` with a TitanCNA run script (R with the
TitanCNA package).

TITAN's inputs:
  * fixed-step WIG read-count tracks (1 kb bins) for tumour and normal;
  * a het-position allele-count table
    (chr, position, refBase, refCount, NrefBase, NrefCount, no header).
TITAN's outputs:
  * ``params.txt``: ``name: v1 v2 ...`` lines with the S_Dbw validity
    index, the normal contamination and the clonal clusters' cellular
    prevalences;
  * a segments TSV with Chromosome/Start_Position(bp)/End_Position(bp)/
    Copy_Number/MajorCN/MinorCN/Clonal_Cluster columns.
"""

import os
import subprocess

import numpy as np

from remixt_tpu_torch.io.table import Table, read_tsv, write_tsv
from remixt_tpu_torch.wrappers import formats


def write_wig(wig_filename, seqdata_filename, chromosome_lengths,
              bin_size=1000):
    """Fixed-step WIG track of binned fragment counts."""
    with open(wig_filename, 'w') as wig:
        for chromosome, counts in formats.binned_read_counts(
                seqdata_filename, chromosome_lengths, bin_size):
            wig.write('fixedStep chrom={0} start=1 step={1} span={1}\n'
                      .format(chromosome, bin_size))
            wig.write('\n'.join(str(int(c)) for c in counts))
            wig.write('\n')


def write_het_alleles(allele_filename, het_counts):
    """TITAN's allele-count table from the het tumour counts of
    ``formats.het_tumour_allele_counts``.

    The seqdata store does not keep the bases; TITAN uses only the counts,
    so fixed placeholder bases are written.
    """
    n = len(het_counts)
    write_tsv(Table([
        ('chr', het_counts['chromosome']),
        ('position', het_counts['position']),
        ('refBase', np.full(n, 'A', dtype=object)),
        ('refCount', het_counts['ref_count'].astype(np.int64)),
        ('NrefBase', np.full(n, 'T', dtype=object)),
        ('NrefCount', het_counts['alt_count'].astype(np.int64)),
    ]), allele_filename, header=False)


def prepare_inputs(analysis_dir, normal_seqdata, tumour_seqdata,
                   chromosome_lengths, bin_size=1000):
    """Write every TITAN input under analysis_dir; returns their paths."""
    os.makedirs(analysis_dir, exist_ok=True)
    paths = {
        'normal_wig': os.path.join(analysis_dir, 'normal.wig'),
        'tumour_wig': os.path.join(analysis_dir, 'tumour.wig'),
        'alleles': os.path.join(analysis_dir, 'alleles.tsv'),
    }
    write_wig(paths['normal_wig'], normal_seqdata, chromosome_lengths,
              bin_size)
    write_wig(paths['tumour_wig'], tumour_seqdata, chromosome_lengths,
              bin_size)
    write_het_alleles(paths['alleles'], formats.het_tumour_allele_counts(
        normal_seqdata, tumour_seqdata))
    return paths


def run(analysis_dir, run_titan_script, num_clusters, ploidy_init,
        normal_init, out_subdir):
    """One TITAN restart through the TitanCNA run script; returns its
    output directory."""
    paths = {
        'tumour_wig': os.path.join(analysis_dir, 'tumour.wig'),
        'normal_wig': os.path.join(analysis_dir, 'normal.wig'),
        'alleles': os.path.join(analysis_dir, 'alleles.tsv'),
    }
    outdir = os.path.join(analysis_dir, out_subdir)
    os.makedirs(outdir, exist_ok=True)
    subprocess.check_call([
        'Rscript', run_titan_script,
        paths['alleles'], paths['tumour_wig'], paths['normal_wig'],
        str(num_clusters), str(ploidy_init), str(normal_init),
        os.path.join(outdir, 'cn.tsv'),
        os.path.join(outdir, 'params.txt'),
    ])
    return outdir


def read_params(params_filename):
    """TITAN's ``name: v1 v2 ...`` parameter file as {name: float
    array}."""
    parsed = {}
    with open(params_filename) as f:
        for line in f:
            if ':' not in line:
                continue
            name, _, values = line.partition(':')
            parsed[name.strip()] = np.array(values.split(), dtype=float)
    return parsed


def select_best_restart(params_by_restart):
    """The restart of the least S_Dbw validity index (the first of
    equals)."""
    scores = {idx: p['S_Dbw validity index'][0]
              for idx, p in params_by_restart.items()}
    return min(scores, key=scores.get)


def convert_mix(params, num_clusters):
    """The clone mixture from the normal contamination and the cellular
    prevalences.

    One cluster: [normal, tumour]; two clusters: the dominant clone
    carries the smaller prevalence, the other the difference of the two.
    """
    n = float(params['Normal contamination estimate'][0])
    prev = params[
        'Clonal cluster cellular prevalence Z={}'.format(num_clusters)]
    if num_clusters == 1:
        return [n, (1 - n) * float(prev[0])]
    if num_clusters == 2:
        t1, t2 = float(prev[0]), float(prev[1])
        return [n, (1 - n) * t2, (1 - n) * abs(t1 - t2)]
    raise ValueError('unsupported cluster count {}'.format(num_clusters))


def convert_cn_table(titan_segments):
    """TITAN's segment calls (a Table) as the standard cn table.

    Clonal segments (Clonal_Cluster 1, or missing) go into both tumour
    clones; the other segments get a diploid clone 2.
    """
    cluster = titan_segments['Clonal_Cluster']
    if cluster.dtype.kind == 'f':
        cluster = np.where(np.isnan(cluster), 1, cluster)
    clonal = cluster.astype(np.int64) == 1
    total = titan_segments['Copy_Number']
    major = titan_segments['MajorCN']
    minor = titan_segments['MinorCN']
    return Table([
        ('chromosome', titan_segments['Chromosome']),
        ('start', titan_segments['Start_Position(bp)']),
        ('end', titan_segments['End_Position(bp)']),
        ('total_1', total),
        ('major_1', major),
        ('minor_1', minor),
        ('total_2', np.where(clonal, total, 2)),
        ('major_2', np.where(clonal, major, 1)),
        ('minor_2', np.where(clonal, minor, 1)),
    ])


def write_mix(output_mix_filename, mix):
    """A mixture as one tab-separated line of ``str(float)``."""
    with open(output_mix_filename, 'w') as f:
        f.write('\t'.join(str(a) for a in mix) + '\n')


def report(restart_dirs, output_cn_filename, output_mix_filename,
           num_clusters_by_restart):
    """Select the best restart and write the standard cn and mix
    outputs."""
    params_by_restart = {
        idx: read_params(os.path.join(d, 'params.txt'))
        for idx, d in restart_dirs.items()}
    best = select_best_restart(params_by_restart)

    write_mix(output_mix_filename, convert_mix(
        params_by_restart[best], num_clusters_by_restart[best]))

    segments = read_tsv(os.path.join(restart_dirs[best], 'cn.tsv'),
                        str_columns=('Chromosome',))
    write_tsv(convert_cn_table(segments), output_cn_filename)
