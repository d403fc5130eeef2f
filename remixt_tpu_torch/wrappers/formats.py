"""The two views of a seqdata store that the external callers read
(counterpart of ``remixt_tpu/wrappers/formats.py``): fixed-width binned
read counts per chromosome, and tumour allele counts at the positions
called heterozygous in the matched normal. The per-tool modules only
reformat them.

The stores are either form of ``seqdataio`` (HDF5 or a directory of
``.npy`` chunks). Chromosomes are visited in the order of
``seqdataio.read_chromosomes``' set, as the JAX package visits them.
"""

import numpy as np

from remixt_tpu_torch import segalg, seqdataio
from remixt_tpu_torch.analysis import haplotype
from remixt_tpu_torch.io.table import Table, inner_join

HET_COLUMNS = ['chromosome', 'position', 'ref_count', 'alt_count']


def _fragment_bounds(seqdata_filename, chromosome):
    """(fragments, 2) start and end of a chromosome's fragments, with the
    reader's default duplicate and mapping-quality filters."""
    fragments = seqdataio.read_fragment_data(seqdata_filename, chromosome)
    return np.stack([fragments['start'], fragments['end']], axis=1)


def binned_read_counts(seqdata_filename, chromosome_lengths, bin_size=1000):
    """Fragment counts on a fixed bin grid.

    Yields (chromosome, counts ndarray) in the store's chromosome order;
    bins span [i*bin_size, (i+1)*bin_size) up to the chromosome length.
    """
    for chromosome in seqdataio.read_chromosomes(seqdata_filename):
        num_bins = int(np.ceil(chromosome_lengths[chromosome] / bin_size))
        bounds = np.arange(num_bins + 1, dtype=np.int64) * bin_size
        bins = np.stack([bounds[:-1], bounds[1:]], axis=1)
        yield chromosome, segalg.contained_counts(
            bins, _fragment_bounds(seqdata_filename, chromosome))


def het_tumour_allele_counts(normal_seqdata, tumour_seqdata):
    """Tumour ref/alt counts at heterozygous SNPs called from the normal.

    Returns a Table of chromosome, position, ref_count and alt_count,
    concatenated over the chromosomes of the normal store, each in the
    tumour's position order.
    """
    tables = []
    for chromosome in seqdataio.read_chromosomes(normal_seqdata):
        normal_counts = haplotype.read_snp_counts(normal_seqdata, chromosome)
        haplotype.infer_snp_genotype(normal_counts)
        het = Table([('position', normal_counts['position'][
            normal_counts['AB'] == 1])])
        tumour_counts = inner_join(
            haplotype.read_snp_counts(tumour_seqdata, chromosome), het,
            on='position')
        tables.append([
            np.array([chromosome] * len(tumour_counts), dtype=object),
            tumour_counts['position'],
            tumour_counts['ref_count'].astype(np.int64),
            tumour_counts['alt_count'].astype(np.int64)])
    if not tables:
        return Table([(name, np.array([], dtype=object))
                      for name in HET_COLUMNS])
    return Table([(name, np.concatenate([t[k] for t in tables]))
                  for k, name in enumerate(HET_COLUMNS)])


def segment_read_counts(seqdata_filename, segments):
    """Fragment counts for an explicit segment table (a Table with
    chromosome, start and end, start-sorted within a chromosome); returns
    the table with a float 'count' column added."""
    out = Table(list(segments.items()))
    counts = np.zeros(len(segments))
    chromosomes = np.asarray(segments['chromosome'])
    for chromosome in seqdataio.read_chromosomes(seqdata_filename):
        on_chrom = chromosomes == chromosome
        if not on_chrom.any():
            continue
        counts[on_chrom] = segalg.contained_counts(
            np.stack([segments['start'][on_chrom],
                      segments['end'][on_chrom]], axis=1),
            _fragment_bounds(seqdata_filename, chromosome))
    out['count'] = counts
    return out
