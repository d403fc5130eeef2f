"""Mappability tasks: the genome's k-mers, their realignments' bedgraph and
the mappability store.

Counterpart of ``remixt_tpu/mappability/tasks.py``, without pandas. The
store follows the port's rule (``io/store.is_hdf5``): a name ending in
``.h5`` is the JAX package's HDF5 store (group ``chromosome_X`` with
``start``, ``end`` and ``quality`` datasets; h5py imported inside the
function); any other name is a directory of ``chromosome_X/start.npy``,
``end.npy`` and ``quality.npy``. ``analysis/gcbias.py`` reads either
(``read_mappability_indicator``).

Where the JAX functions raise, these write empty output: a chunk of
alignments with no alignment line, or with none at its k-mer's origin (a
chunk that lies wholly in a repeat), gives an empty bedgraph, and no
shards an empty store.
"""

import itertools
import os
import shutil

import numpy as np

from remixt_tpu_torch.io.store import is_hdf5
from remixt_tpu_torch.utils import read_sequences

STORE_COLUMNS = ('start', 'end', 'quality')


def n_free_windows(sequence, k):
    """Starts of the windows of length ``k`` of an upper-case ASCII
    sequence that hold no ``N``, in order."""
    bases = np.frombuffer(sequence.encode('ascii'), dtype=np.uint8)
    if len(bases) < k:
        return np.zeros(0, dtype=np.int64)
    n_count = np.concatenate([[0], np.cumsum(bases == ord('N'))])
    return np.flatnonzero(n_count[k:] == n_count[:-k])


def create_kmers(genome_fasta, k, kmers_filename):
    """FASTA of every N-free k-mer of the genome (upper case), named
    chromosome:start (0-based), chromosome by chromosome in file order."""
    with open(kmers_filename, 'w') as kmers_file:
        for chromosome, sequence in read_sequences(genome_fasta):
            chromosome = chromosome.split()[0]
            sequence = sequence.upper()
            starts = n_free_windows(sequence, k).tolist()
            for block in range(0, len(starts), 1 << 16):
                kmers_file.write(''.join(
                    '>{0}:{1}\n{2}\n'.format(
                        chromosome, start, sequence[start:start + k])
                    for start in starts[block:block + (1 << 16)]))


def split_file_byline(in_filename, lines_per_file, out_filename_callback):
    """Shard a text file into consecutive ``lines_per_file`` chunks."""
    with open(in_filename, 'r') as in_file:
        for shard in itertools.count():
            lines = list(itertools.islice(in_file, lines_per_file))
            if not lines:
                break
            with open(out_filename_callback(shard), 'w') as out_file:
                out_file.writelines(lines)


def _origin_true_alignments(alignment_filename):
    """(chromosome, position, quality) arrays of the SAM rows that place a
    k-mer at its origin (the read name is chromosome:start), in file
    order; every row counts, unmapped and secondary ones too."""
    chroms, positions, quals = [], [], []
    with open(alignment_filename, 'r') as alignment_file:
        for line in alignment_file:
            if line.startswith('@'):
                continue
            fields = line.split('\t', 5)
            position = int(fields[3]) - 1  # SAM is 1-based
            origin_chrom, _, origin_start = fields[0].rpartition(':')
            if origin_chrom == fields[2] and int(origin_start) == position:
                chroms.append(fields[2])
                positions.append(position)
                quals.append(int(fields[4]))
    return (np.array(chroms, dtype=str), np.array(positions, dtype=np.int64),
            np.array(quals, dtype=np.int64))


def _run_length_encode(chrom, pos, qual):
    """Consecutive same-quality positions collapsed into intervals
    (chromosome, start, end, quality); the rows sorted by (chromosome,
    position). A new interval opens where the chromosome changes, a
    position is skipped or repeated, or the quality changes."""
    opens = np.ones(len(pos), dtype=bool)
    opens[1:] = ((chrom[1:] != chrom[:-1])
                 | (pos[1:] != pos[:-1] + 1)
                 | (qual[1:] != qual[:-1]))
    start_idx = np.flatnonzero(opens)
    end_idx = np.concatenate([start_idx[1:], [len(pos)]]).astype(np.int64) - 1
    return chrom[start_idx], pos[start_idx], pos[end_idx] + 1, qual[start_idx]


def create_bedgraph(alignment_filename, bedgraph_filename):
    """The per-position mapping quality of the k-mers realigned at their
    origin, as bedgraph intervals (chromosome, start, end, quality)
    sorted by chromosome name and start; empty where no k-mer realigned
    at its origin."""
    chrom, pos, qual = _origin_true_alignments(alignment_filename)
    with open(bedgraph_filename, 'w') as bedgraph:
        if not len(pos):
            return
        _, codes = np.unique(chrom, return_inverse=True)
        order = np.lexsort((pos, codes))  # stable, as the JAX mergesort
        columns = _run_length_encode(chrom[order], pos[order], qual[order])
        bedgraph.writelines(
            '{}\t{}\t{}\t{}\n'.format(*row)
            for row in zip(*(column.tolist() for column in columns)))


def read_bedgraph_shards(in_filenames):
    """{chromosome: (start, end, quality) int64 arrays} of the shards in
    their order, the chromosomes sorted by name; empty shards add
    nothing."""
    rows = {}
    for name in in_filenames:
        with open(name) as shard:
            for line in shard:
                chromosome, start, end, quality = line.rstrip('\n').split(
                    '\t')
                rows.setdefault(chromosome, []).append(
                    (int(start), int(end), int(quality)))
    return {chromosome: tuple(np.array(column, dtype=np.int64)
                              for column in zip(*rows[chromosome]))
            for chromosome in sorted(rows)}


def write_mappability_store(out_filename, tables):
    """Write ``{chromosome: (start, end, quality)}`` as the mappability
    store ``out_filename``, replacing what was there: the JAX package's
    HDF5 layout for a name ending in ``.h5``, else a directory, written
    beside it and renamed into place."""
    if is_hdf5(out_filename):
        import h5py
        with h5py.File(out_filename, 'w') as store:
            for chromosome, columns in tables.items():
                group = store.create_group('chromosome_' + chromosome)
                for column, values in zip(STORE_COLUMNS, columns):
                    group.create_dataset(
                        column, data=values, compression='gzip',
                        compression_opts=4)
        return
    staging = out_filename.rstrip('/') + '.partial'
    shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    for chromosome, columns in tables.items():
        path = os.path.join(staging, 'chromosome_' + chromosome)
        os.makedirs(path)
        for column, values in zip(STORE_COLUMNS, columns):
            np.save(os.path.join(path, column + '.npy'), values)
    shutil.rmtree(out_filename, ignore_errors=True)
    os.replace(staging, out_filename)


def merge_files_by_line(in_filenames, out_filename):
    """Merge the bedgraph shards ``{key: filename}`` into the mappability
    store ``out_filename``; no shards give an empty store."""
    write_mappability_store(out_filename,
                            read_bedgraph_shards(in_filenames.values()))
