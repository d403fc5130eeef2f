"""Read-count tasks of the ``run`` path: segment counts, allele counts,
cross-tumour phasing, the final count table (TSVs in, TSVs out).

Counterpart of ``remixt_tpu/analysis/readcount.py``.
"""

import remixt_tpu_torch.config
from remixt_tpu_torch.analysis import haplotype, segment
from remixt_tpu_torch.io.table import read_tsv, write_tsv


def _filters(config):
    return dict(
        filter_duplicates=remixt_tpu_torch.config.get_param(
            config, 'filter_duplicates'),
        map_qual_threshold=remixt_tpu_torch.config.get_param(
            config, 'map_qual_threshold'))


def segment_readcount(segment_counts_filename, segment_filename,
                      seqdata_filename, config):
    segments = read_tsv(segment_filename, str_columns=('chromosome',))
    write_tsv(segment.create_segment_counts(segments, seqdata_filename,
                                            **_filters(config)),
              segment_counts_filename)


def haplotype_allele_readcount(allele_counts_filename, segment_filename,
                               seqdata_filename, haps_filename, config):
    segments = read_tsv(segment_filename, str_columns=('chromosome',))
    write_tsv(haplotype.create_allele_counts(
        segments, seqdata_filename, haps_filename, **_filters(config)),
        allele_counts_filename)


def phase_segments(allele_counts_filenames, phased_allele_counts_filenames):
    tables = [read_tsv(filename, str_columns=('chromosome',))
              for filename in allele_counts_filenames.values()]
    for tumour_id, phased in zip(allele_counts_filenames,
                                 haplotype.phase_segments(*tables)):
        write_tsv(phased, phased_allele_counts_filenames[tumour_id])


def prepare_readcount_table(segments_filename, alleles_filename,
                            count_filename):
    segment_data = read_tsv(segments_filename, str_columns=('chromosome',))
    allele_data = read_tsv(alleles_filename, str_columns=('chromosome',))
    write_tsv(segment.create_segment_allele_counts(segment_data,
                                                   allele_data),
              count_filename)
