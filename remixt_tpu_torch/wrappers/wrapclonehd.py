"""cloneHD wrapper: input preparation, execution, result conversion
(counterpart of ``remixt_tpu/wrappers/wrapclonehd.py``).

The input writers and the result parser stand alone; :func:`run` drives
the filterHD and cloneHD binaries.

cloneHD's inputs:
  * a CNA track, headerless TSV: chromosome, bin end, count, num_obs (1);
  * the tumour's BAF track: chromosome, position, minor_count,
    total_count at the normal's het positions.
cloneHD's outputs:
  * ``*.summary.txt``: a '# <n> clones' header, then the mass and each
    clone's fraction;
  * per clone posterior tables ``*.cna.subclone-<i>.txt`` and
    ``*.baf.subclone-<i>.txt``, whitespace-separated, whose columns after
    ``#chr first-locus last-locus nloci`` are candidate copy numbers and
    whose rows are segments: the call is the column of the greatest
    posterior.
"""

import os
import subprocess

import numpy as np

from remixt_tpu_torch import segalg
from remixt_tpu_torch.io.table import Table, read_tsv, write_tsv
from remixt_tpu_torch.wrappers import formats
from remixt_tpu_torch.wrappers.wraptitan import write_mix


def write_cna(cna_filename, seqdata_filename, chromosome_lengths,
              bin_size=1000):
    chromosomes, ends, counts = [], [], []
    for chromosome, binned in formats.binned_read_counts(
            seqdata_filename, chromosome_lengths, bin_size):
        chromosomes.append(np.array([chromosome] * len(binned),
                                    dtype=object))
        ends.append((np.arange(len(binned)) + 1) * bin_size)
        counts.append(binned.astype(np.int64))
    if not counts:
        open(cna_filename, 'w').close()
        return
    write_tsv(Table([
        ('chromosome', np.concatenate(chromosomes)),
        ('end', np.concatenate(ends)),
        ('count', np.concatenate(counts)),
        ('num_obs', np.ones(sum(len(c) for c in counts), dtype=np.int64)),
    ]), cna_filename, header=False)


def write_baf(baf_filename, normal_seqdata, tumour_seqdata):
    het = formats.het_tumour_allele_counts(normal_seqdata, tumour_seqdata)
    write_tsv(Table([
        ('chromosome', het['chromosome']),
        ('position', het['position']),
        ('minor_count', np.minimum(het['ref_count'], het['alt_count'])),
        ('total_count', het['ref_count'] + het['alt_count']),
    ]), baf_filename, header=False)


def prepare_inputs(analysis_dir, normal_seqdata, tumour_seqdata,
                   chromosome_lengths, bin_size=1000):
    os.makedirs(analysis_dir, exist_ok=True)
    paths = {
        'normal_cna': os.path.join(analysis_dir, 'normal.cna.txt'),
        'tumour_cna': os.path.join(analysis_dir, 'tumour.cna.txt'),
        'tumour_baf': os.path.join(analysis_dir, 'tumour.baf.txt'),
    }
    write_cna(paths['normal_cna'], normal_seqdata, chromosome_lengths,
              bin_size)
    write_cna(paths['tumour_cna'], tumour_seqdata, chromosome_lengths,
              bin_size)
    write_baf(paths['tumour_baf'], normal_seqdata, tumour_seqdata)
    return paths


def run(analysis_dir, filterhd_bin, clonehd_bin, seed=123):
    """filterHD on the normal and tumour tracks, then cloneHD."""
    def path(name):
        return os.path.join(analysis_dir, name)

    # four filterHD passes: the plain normal and tumour CNA fits, a tumour
    # CNA fit biased by the normal's posterior that gives the jump track
    # cloneHD reads, and the reflected tumour BAF fit
    subprocess.check_call([
        filterhd_bin, '--data', path('normal.cna.txt'), '--mode', '3',
        '--pre', path('normal.cna'), '--rnd', '0'])
    subprocess.check_call([
        filterhd_bin, '--data', path('tumour.cna.txt'), '--mode', '3',
        '--pre', path('tumour.cna'), '--rnd', '0'])
    subprocess.check_call([
        filterhd_bin, '--data', path('tumour.cna.txt'), '--mode', '3',
        '--pre', path('tumour.cna.bias'),
        '--bias', path('normal.cna.posterior-1.txt'),
        '--sigma', '0', '--jumps', '1', '--rnd', '0'])
    subprocess.check_call([
        filterhd_bin, '--data', path('tumour.baf.txt'), '--mode', '1',
        '--pre', path('tumour.baf'), '--sigma', '0', '--jumps', '1',
        '--reflect', '1', '--dist', '1', '--rnd', '0'])
    subprocess.check_call([
        clonehd_bin,
        '--cna', path('tumour.cna.txt'), '--baf', path('tumour.baf.txt'),
        '--pre', path('tumour'),
        '--bias', path('normal.cna.posterior-1.txt'),
        '--seed', str(seed), '--trials', '2', '--nmax', '3', '--force', '2',
        '--max-tcn', '4',
        '--cna-jumps', path('tumour.cna.bias.jumps.txt'),
        '--baf-jumps', path('tumour.baf.jumps.txt'),
        '--min-jump', '0.01', '--restarts', '10', '--mass-gauging', '1'])


def parse_summary(summary_filename):
    """{num_clones, mass, frac_1..} from cloneHD's summary file."""
    info = {}
    names = []
    with open(summary_filename) as f:
        for line in f:
            if line.startswith('#'):
                names = line[1:].split()
                if len(names) == 2 and names[1] == 'clones':
                    info['num_clones'] = int(names[0])
                    names = ['mass'] + [
                        'frac_{}'.format(i + 1)
                        for i in range(info['num_clones'])]
            elif names:
                info.update(zip(names, line.split()))
    return info


_POSITION_COLUMNS = ('#chr', 'first-locus', 'last-locus', 'nloci')


def _argmax_calls(posterior_filename, bin_size=None):
    """A posterior table as one integer call a segment: the label of its
    column of greatest posterior (NaN as 0; the first column of equals).

    ``bin_size`` shifts the segment starts one bin left: CNA loci are bin
    ends, so CNA tables need it; BAF loci are SNP positions and are not
    shifted.
    """
    data = read_tsv(posterior_filename, whitespace=True)
    labels = [c for c in data.columns if c not in _POSITION_COLUMNS]
    posterior = np.stack([data[c].astype(np.float64) for c in labels],
                         axis=1)
    posterior = np.where(np.isnan(posterior), 0., posterior)
    start = data['first-locus']
    if bin_size is not None:
        start = start - bin_size
    return Table([
        ('chromosome', data['#chr']),
        ('start', start),
        ('end', data['last-locus']),
        ('call', np.array([int(c) for c in labels],
                          dtype=np.int64)[np.argmax(posterior, axis=1)]),
    ])


def clone_cn_table(cna_filename, baf_filename, clone_id, bin_size=1000):
    """A clone's total and allele calls as major, minor and total columns
    on the common refinement of their segmentations; minors below 0 are
    clamped to 0."""
    total = _argmax_calls(cna_filename, bin_size)
    allele = _argmax_calls(baf_filename)

    overlap = segalg.reindex_segments(total, allele)
    total_cn = total['call'][overlap['idx_1']]
    allele_cn = allele['call'][overlap['idx_2']]
    other = total_cn - allele_cn
    return Table([
        ('chromosome', overlap['chromosome']),
        ('start', overlap['start']),
        ('end', overlap['end']),
        ('major_{}'.format(clone_id), np.maximum(allele_cn, other)),
        # cloneHD calls minors below 0; they are clamped
        ('minor_{}'.format(clone_id),
         np.maximum(np.minimum(allele_cn, other), 0)),
        ('total_{}'.format(clone_id), total_cn),
    ])


def _drop_position(table):
    return [(c, v) for c, v in table.items()
            if c not in ('chromosome', 'start', 'end')]


def report(analysis_dir, output_cn_filename, output_mix_filename,
           bin_size=1000):
    """Write the standard cn and mix outputs from a cloneHD run
    directory; the clones' tables merged on the common refinement of
    their segmentations."""
    def path(name):
        return os.path.join(analysis_dir, name)

    info = parse_summary(path('tumour.summary.txt'))
    fracs = [float(info['frac_{}'.format(i + 1)])
             for i in range(info['num_clones'])]
    write_mix(output_mix_filename, [1.0 - sum(fracs)] + fracs)

    table = None
    for clone_id in range(1, info['num_clones'] + 1):
        clone = clone_cn_table(
            path('tumour.cna.subclone-{}.txt'.format(clone_id)),
            path('tumour.baf.subclone-{}.txt'.format(clone_id)),
            clone_id, bin_size)
        if table is None:
            table = clone
            continue
        merged = segalg.reindex_segments(table, clone)
        table = Table(
            [(c, merged[c]) for c in ('chromosome', 'start', 'end')]
            + [(c, v[merged['idx_1']]) for c, v in _drop_position(table)]
            + [(c, v[merged['idx_2']]) for c, v in _drop_position(clone)])

    write_tsv(table, output_cn_filename)
