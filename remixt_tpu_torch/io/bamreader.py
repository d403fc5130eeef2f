"""ctypes binding of the BAM allele reader (``csrc/bam_allele_reader.cpp``).

Counterpart of ``remixt_tpu/io/bamreader.py``: ``AlleleReader(bam, snps,
chromosome, max_fragment_length, max_soft_clipped, check_proper_pair)``
with ``ReadAlignments(n)``, ``GetFragmentTable()`` and
``GetAlleleTable()``, the tables as :class:`~remixt_tpu_torch.io.table.Table`
objects of int32 columns. The library is a copy of the JAX package's
source, built with g++ and zlib at first use into
``build/remixt_tpu_torch/`` (``ops/_build.build_host``); a failed build
raises.
"""

import ctypes

import numpy as np

from remixt_tpu_torch.io.table import Table
from remixt_tpu_torch.ops import _build

FRAGMENT_COLUMNS = ['fragment_id', 'start', 'end', 'mapping_quality',
                    'is_duplicate']
ALLELE_COLUMNS = ['fragment_id', 'position', 'is_alt']

_lib = None


def _load_library():
    global _lib
    if _lib is None:
        lib = _build.load_host('bam_allele_reader')
        lib.allele_reader_create.restype = ctypes.c_void_p
        lib.allele_reader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.allele_reader_destroy.argtypes = [ctypes.c_void_p]
        lib.allele_reader_read_alignments.restype = ctypes.c_int
        lib.allele_reader_read_alignments.argtypes = [ctypes.c_void_p,
                                                      ctypes.c_int]
        lib.allele_reader_num_fragments.restype = ctypes.c_long
        lib.allele_reader_num_fragments.argtypes = [ctypes.c_void_p]
        lib.allele_reader_num_alleles.restype = ctypes.c_long
        lib.allele_reader_num_alleles.argtypes = [ctypes.c_void_p]
        lib.allele_reader_get_fragments.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.allele_reader_get_alleles.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.allele_reader_last_error.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class AlleleReader:
    """Stream one chromosome's fragments and SNP allele calls from a
    coordinate-sorted BAM with its ``.bai``."""

    def __init__(self, bam_filename, snp_filename, chromosome,
                 max_fragment_length, max_soft_clipped, check_proper_pair):
        self._lib = _load_library()
        self._reader = self._lib.allele_reader_create(
            str(bam_filename).encode(),
            str(snp_filename).encode() if snp_filename else b'',
            str(chromosome).encode(),
            int(max_fragment_length),
            int(max_soft_clipped),
            int(bool(check_proper_pair)))
        if not self._reader:
            raise IOError(self._lib.allele_reader_last_error().decode())

    def __del__(self):
        if getattr(self, '_reader', None):
            self._lib.allele_reader_destroy(self._reader)
            self._reader = None

    def ReadAlignments(self, max_alignments):
        """Process up to ``max_alignments`` records; True while data
        remains."""
        result = self._lib.allele_reader_read_alignments(
            self._reader, int(max_alignments))
        if result < 0:
            raise IOError(self._lib.allele_reader_last_error().decode())
        return bool(result)

    def _table(self, count, get, columns):
        n = count(self._reader)
        buf = np.zeros((n, len(columns)), dtype=np.int32)
        if n:
            get(self._reader,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return Table([(name, buf[:, k].copy())
                      for k, name in enumerate(columns)])

    def GetFragmentTable(self):
        """This batch's fragments: fragment_id, start, end,
        mapping_quality, is_duplicate."""
        return self._table(self._lib.allele_reader_num_fragments,
                           self._lib.allele_reader_get_fragments,
                           FRAGMENT_COLUMNS)

    def GetAlleleTable(self):
        """This batch's SNP allele calls: fragment_id, position (1-based),
        is_alt."""
        return self._table(self._lib.allele_reader_num_alleles,
                           self._lib.allele_reader_get_alleles,
                           ALLELE_COLUMNS)
