"""Fragment-length statistics over a seqdata store.

Counterpart of ``remixt_tpu/analysis/stats.py``: the mean and standard
deviation of the mapped fragment lengths feed the GC-bias model's
fragment-length integral. Lengths are reduced chunk by chunk to (count,
sum, sum of squares) triples, so the store is never resident whole. A
store without a fragment raises ``ValueError`` (the JAX package fails
there with a ``TypeError``).
"""

import collections

import numpy as np

import remixt_tpu_torch.config
from remixt_tpu_torch import seqdataio
from remixt_tpu_torch.utils import sort_chromosome_names

FragmentStats = collections.namedtuple('FragmentStats', [
    'fragment_mean',
    'fragment_stddev',
])


def _chunk_moments(seqdata_filename, config):
    """Yield one (n, Σx, Σx²) triple per fragment chunk in the store."""
    filters = dict(
        filter_duplicates=remixt_tpu_torch.config.get_param(
            config, 'filter_duplicates'),
        map_qual_threshold=remixt_tpu_torch.config.get_param(
            config, 'map_qual_threshold'),
    )
    for chromosome in sort_chromosome_names(
            seqdataio.read_chromosomes(seqdata_filename)):
        chunks = seqdataio.read_fragment_data(
            seqdata_filename, chromosome, chunksize=1000000, **filters)
        for fragments in chunks:
            lengths = (fragments['end'] - fragments['start']).astype(
                np.float64)
            yield np.array([lengths.size, lengths.sum(), lengths @ lengths])


def calculate_fragment_stats(seqdata_filename, config):
    """Mean and standard deviation of the fragment length across all
    chromosomes of a store."""
    count, first, second = sum(_chunk_moments(seqdata_filename, config),
                               np.zeros(3))
    if count == 0:
        raise ValueError('no fragments in seqdata store {} (after the '
                         'duplicate and mapping-quality filters)'.format(
                             seqdata_filename))
    mean = first / count
    variance = second / count - mean ** 2
    return FragmentStats(mean, np.sqrt(variance))
