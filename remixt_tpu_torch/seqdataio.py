"""Seqdata store: per-chromosome fragment and allele tables.

Counterpart of ``remixt_tpu/seqdataio.py``. A store whose name ends in
``.h5`` is an HDF5 file in the JAX package's layout (resizable per-column
int64 datasets under ``/fragments/chromosome_X`` and
``/alleles/chromosome_X``, an ``nrows`` attribute on each group; h5py
imported inside the functions), so each package reads the other's file.
Any other name is a directory of ``.npy`` column chunks,
``<record type>/chromosome_X/<chunk>.<column>.npy``, which needs nothing
beyond numpy and serves where h5py is not installed; the workflows pick
the form with ``io/store.store_name``, as for results stores. Fragment ids
stay globally unique across appended chunks; reads stream in chunks of a
fixed row count in both forms.
"""

import os
import shutil

import numpy as np

from remixt_tpu_torch.io.store import is_hdf5
from remixt_tpu_torch.io.table import Table

FRAGMENT_COLUMNS = ['fragment_id', 'start', 'end', 'mapping_quality',
                    'is_duplicate']
ALLELE_COLUMNS = ['fragment_id', 'position', 'is_alt']
COLUMNS = {'fragments': FRAGMENT_COLUMNS, 'alleles': ALLELE_COLUMNS}
RECORD_TYPES = ('fragments', 'alleles')


def empty_table(record_type):
    return Table([(c, np.array([], dtype=np.int32))
                  for c in COLUMNS[record_type]])


def _get_key(record_type, chromosome):
    return '/{}/chromosome_{}'.format(record_type, chromosome)


# ---------------------------------------------------------------------------
# the two forms: append, row count, row window, chromosomes
# ---------------------------------------------------------------------------

def _h5_append(f, key, data, columns):
    """Append rows to resizable per-column datasets (the JAX layout)."""
    group = f.require_group(key)
    nrows = group.attrs.get('nrows', 0)
    for col in columns:
        values = np.asarray(data[col]).astype(np.int64)
        if col not in group:
            group.create_dataset(
                col, data=values, maxshape=(None,), chunks=(1 << 18,),
                compression='gzip', compression_opts=4)
        else:
            ds = group[col]
            ds.resize((nrows + len(values),))
            ds[nrows:] = values
    group.attrs['nrows'] = nrows + len(data)


def _table_dir(directory, record_type, chromosome):
    return os.path.join(directory, record_type,
                        'chromosome_{}'.format(chromosome))


def _dir_chunks(path):
    """The chunk numbers of a table directory, in order."""
    return sorted({int(name.split('.')[0]) for name in os.listdir(path)
                   if name.endswith('.npy')})


def _dir_append(directory, record_type, chromosome, data, columns):
    path = _table_dir(directory, record_type, chromosome)
    os.makedirs(path, exist_ok=True)
    if len(data) == 0:
        return
    chunks = _dir_chunks(path)
    chunk = chunks[-1] + 1 if chunks else 0
    for col in columns:
        np.save(os.path.join(path, '{:06d}.{}.npy'.format(chunk, col)),
                np.asarray(data[col]).astype(np.int64))


class _Reader:
    """Row windows of one table of a store, in either form."""

    def __init__(self, filename, record_type, chromosome):
        self.columns = COLUMNS[record_type]
        self.record_type = record_type
        if is_hdf5(filename):
            import h5py
            self._file = h5py.File(filename, 'r')
            key = _get_key(record_type, chromosome)
            self.present = key in self._file
            if self.present:
                group = self._file[key]
                self.nrows = int(group.attrs.get('nrows', 0))
                self._data = {col: group[col] for col in self.columns}
        else:
            self._file = None
            path = _table_dir(filename, record_type, chromosome)
            self.present = os.path.isdir(path)
            if self.present:
                self._pieces = {col: [np.load(os.path.join(
                    path, '{:06d}.{}.npy'.format(chunk, col)),
                    mmap_mode='r') for chunk in _dir_chunks(path)]
                    for col in self.columns}
                sizes = [len(p) for p in self._pieces[self.columns[0]]]
                self._offsets = np.concatenate([[0], np.cumsum(sizes)])
                self.nrows = int(self._offsets[-1])
        if not self.present:
            self.nrows = 0

    def close(self):
        if self._file is not None:
            self._file.close()

    def _column(self, col, start, stop):
        if self._file is not None:
            return self._data[col][start:stop]
        start = 0 if start is None else min(start, self.nrows)
        stop = self.nrows if stop is None else min(stop, self.nrows)
        parts = []
        for k, piece in enumerate(self._pieces[col]):
            lo, hi = self._offsets[k], self._offsets[k + 1]
            if hi > start and lo < stop:
                parts.append(np.asarray(
                    piece[max(start - lo, 0):min(stop, hi) - lo]))
        if not parts:
            return np.array([], dtype=np.int64)
        return np.concatenate(parts)

    def table(self, start=None, stop=None):
        if not self.present:
            return empty_table(self.record_type)
        return Table([(col, self._column(col, start, stop))
                      for col in self.columns])


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

class Writer:
    """Streaming writer of a new seqdata store (either form)."""

    def __init__(self, seqdata_filename):
        self.filename = seqdata_filename
        if is_hdf5(seqdata_filename):
            import h5py
            self.store = h5py.File(seqdata_filename, 'w')
        else:
            self.store = None
            shutil.rmtree(seqdata_filename, ignore_errors=True)
            os.makedirs(seqdata_filename)

    def write(self, chromosome, fragment_data, allele_data):
        """Append a chunk of fragment and allele data (Tables); nominal
        mapping_quality 60 and is_duplicate 0 added when missing."""
        fragment_data = Table(list(fragment_data.items()))
        if 'mapping_quality' not in fragment_data:
            fragment_data['mapping_quality'] = np.full(len(fragment_data), 60)
        if 'is_duplicate' not in fragment_data:
            fragment_data['is_duplicate'] = np.zeros(len(fragment_data),
                                                     dtype=int)
        self.write_table('fragments', chromosome, fragment_data)
        self.write_table('alleles', chromosome, allele_data)

    def write_table(self, record_type, chromosome, data):
        if self.store is not None:
            _h5_append(self.store, _get_key(record_type, chromosome), data,
                       COLUMNS[record_type])
        else:
            _dir_append(self.filename, record_type, chromosome, data,
                        COLUMNS[record_type])

    def close(self):
        if self.store is not None:
            self.store.close()


def create_chromosome_seqdata(seqdata_filename, bam_filename, snp_filename,
                              chromosome, max_fragment_length,
                              max_soft_clipped, check_proper_pair):
    """Extract one chromosome's fragments and alleles from a BAM into a new
    seqdata store, through the BAM allele reader."""
    from remixt_tpu_torch.io import bamreader

    reader = bamreader.AlleleReader(
        bam_filename, snp_filename, chromosome,
        max_fragment_length, max_soft_clipped, check_proper_pair)

    writer = Writer(seqdata_filename)
    try:
        while reader.ReadAlignments(10000000):
            writer.write(chromosome, reader.GetFragmentTable(),
                         reader.GetAlleleTable())
    finally:
        writer.close()


def create_seqdata(seqdata_filename, bam_filename, snp_filename,
                   max_fragment_length, max_soft_clipped, check_proper_pair,
                   tempdir, chromosomes):
    """Extract every chromosome into its own store in ``tempdir`` (of the
    output's form), then merge them."""
    os.makedirs(tempdir, exist_ok=True)
    suffix = '.h5' if is_hdf5(seqdata_filename) else ''

    all_seqdata = {}
    for chrom in chromosomes:
        chrom_seqdata = os.path.join(tempdir,
                                     '{}_seqdata{}'.format(chrom, suffix))
        all_seqdata[chrom] = chrom_seqdata
        create_chromosome_seqdata(
            chrom_seqdata, bam_filename, snp_filename, chrom,
            max_fragment_length, max_soft_clipped, check_proper_pair)

    merge_seqdata(seqdata_filename, all_seqdata)


def merge_seqdata(out_filename, in_filenames):
    """Merge seqdata stores ({key: filename}) of disjoint chromosome sets
    into a new store; the forms of the inputs and the output may differ."""
    writer = Writer(out_filename)
    try:
        for in_filename in in_filenames.values():
            for chromosome in sorted(read_chromosomes(in_filename)):
                for record_type in RECORD_TYPES:
                    reader = _Reader(in_filename, record_type, chromosome)
                    try:
                        if reader.present:
                            writer.write_table(record_type, chromosome,
                                               reader.table())
                    finally:
                        reader.close()
    finally:
        writer.close()


def merge_overlapping_seqdata(outfile, infiles, chromosomes):
    """Merge seqdata stores ({key: filename}) that may share chromosomes
    into a new store, in ``infiles``' order: each input's fragment ids on a
    chromosome are offset past the ids merged so far there, so that they
    stay unique. An input lacking either table of a chromosome adds
    nothing to it, and an empty table adds no ids. The forms of the inputs
    and the output may differ."""
    offsets = dict.fromkeys(chromosomes, 0)
    writer = Writer(outfile)
    try:
        for infile in infiles.values():
            for chromosome in chromosomes:
                readers = [_Reader(infile, record_type, chromosome)
                           for record_type in ('alleles', 'fragments')]
                try:
                    if not all(reader.present for reader in readers):
                        continue
                    tables = [reader.table() for reader in readers]
                finally:
                    for reader in readers:
                        reader.close()
                for table in tables:
                    table['fragment_id'] = (table['fragment_id'].astype(
                        np.int64) + offsets[chromosome])
                id_maxes = [int(table['fragment_id'].max())
                            for table in tables if len(table) > 0]
                if id_maxes:
                    offsets[chromosome] = max(id_maxes) + 1
                for record_type, table in zip(('alleles', 'fragments'),
                                              tables):
                    writer.write_table(record_type, chromosome, table)
    finally:
        writer.close()


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _drop(table, name):
    return Table([(c, v) for c, v in table.items() if c != name],
                 index=table.index)


def _filter_reads(reads, filter_duplicates, map_qual_threshold, keep_cols):
    if 'is_duplicate' in reads and filter_duplicates is not None:
        if filter_duplicates:
            reads = reads.take(reads['is_duplicate'] == 0)
        if not keep_cols:
            reads = _drop(reads, 'is_duplicate')
    if 'mapping_quality' in reads and map_qual_threshold is not None:
        reads = reads.take(reads['mapping_quality'] >= map_qual_threshold)
        if not keep_cols:
            reads = _drop(reads, 'mapping_quality')
    return reads


def read_seq_data(seqdata_filename, record_type, chromosome, chunksize=None,
                  post=lambda x: x):
    """One table, whole or as an iterator of chunks of ``chunksize`` rows
    (``nrows // chunksize + 1`` of them, the last possibly empty, as the
    JAX package yields them); ``post`` applied to each."""
    if chunksize is None:
        reader = _Reader(seqdata_filename, record_type, chromosome)
        try:
            return post(reader.table())
        finally:
            reader.close()

    def chunk_iter():
        reader = _Reader(seqdata_filename, record_type, chromosome)
        try:
            if reader.nrows == 0:
                yield empty_table(record_type)
                return
            for i in range(reader.nrows // chunksize + 1):
                yield post(reader.table(i * chunksize, (i + 1) * chunksize))
        finally:
            reader.close()

    return chunk_iter()


def read_fragment_data(seqdata_filename, chromosome, filter_duplicates=False,
                       map_qual_threshold=1, keep_cols=False, chunksize=None):
    """Fragment table with duplicate and mapping-quality filtering."""
    def post(reads):
        return _filter_reads(reads, filter_duplicates, map_qual_threshold,
                             keep_cols)
    return read_seq_data(seqdata_filename, 'fragments', chromosome,
                         chunksize=chunksize, post=post)


def read_allele_data(seqdata_filename, chromosome, chunksize=None):
    """Allele table: fragment_id, position (1-based), is_alt."""
    return read_seq_data(seqdata_filename, 'alleles', chromosome,
                         chunksize=chunksize)


def read_chromosomes(seqdata_filename):
    """The set of chromosomes present in a seqdata store.

    Both forms add the names in HDF5's visiting order (record types and
    then tables by name), so that the set iterates as the JAX package's
    does in the same process: the external tools' input files follow that
    order."""
    if is_hdf5(seqdata_filename):
        import h5py
        chromosomes = set()
        with h5py.File(seqdata_filename, 'r') as store:
            def visit(name, obj):
                if 'chromosome_' in name and isinstance(obj, h5py.Group):
                    chromosomes.add(name[name.index('chromosome_')
                                         + len('chromosome_'):])
            store.visititems(visit)
        return chromosomes
    chromosomes = set()
    for record_type in sorted(RECORD_TYPES):
        path = os.path.join(seqdata_filename, record_type)
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.startswith('chromosome_'):
                    chromosomes.add(name[len('chromosome_'):])
    return chromosomes
