"""The port's BAM allele reader (``remixt_tpu_torch/io/bamreader.py``, the
library built from ``remixt_tpu_torch/csrc/bam_allele_reader.cpp``)
against the JAX package's, on the BAM fixtures of ``tests/test_bamreader.py``
(built there in pure Python) and on a random one made from a seed: the
fragment and allele tables of every batch equal. Then
``create_chromosome_seqdata`` of both packages on the random BAM: the
stores equal, in both of the port's forms."""

import os

import numpy as np
import pytest

from test_bamreader import bam_record, write_bam
from test_bamreader import make_pair as make_pair_tuple


def make_pair(*args, **kwargs):
    return list(make_pair_tuple(*args, **kwargs))


def write_inputs(tmp_path, read_dicts, snps=None):
    """The BAM (and SNP file) of ``read_dicts``, as
    ``test_bamreader.build_reader`` writes them."""
    read_dicts = sorted(read_dicts, key=lambda r: r['pos'])
    records = [bam_record(refid=0, cigar=r.get('cigar'), **{
        k: v for k, v in r.items() if k != 'cigar'}) for r in read_dicts]
    bam_path = str(tmp_path / 'test.bam')
    write_bam(bam_path, records)
    snp_path = ''
    if snps is not None:
        snp_path = str(tmp_path / 'snps.tsv')
        with open(snp_path, 'w') as f:
            for chrom, pos, ref, alt in snps:
                f.write('{}\t{}\t{}\t{}\n'.format(chrom, pos + 1, ref, alt))
    return bam_path, snp_path


def simple():
    return (make_pair('frag_a', 100, 300, 50)
            + make_pair('frag_b', 200, 500, 50, mapq=30)), None, {}


def discordant():
    reads = make_pair('ok', 100, 300, 50) + make_pair('toolong', 200, 5000,
                                                       50)
    r1, r2 = make_pair('improper', 400, 600, 50)
    r1['flag'] &= ~0x2
    r2['flag'] &= ~0x2
    return reads + [r1, r2], None, {}


def soft_clipped():
    r1, r2 = make_pair('clipped', 400, 600, 50)
    r1['cigar'] = [(20, 4), (30, 0)]
    return make_pair('ok', 100, 300, 50) + [r1, r2], None, {}


def duplicate():
    r1, r2 = make_pair('dup', 100, 300, 50)
    r1['flag'] |= 0x400
    return [r1, r2] + make_pair('plain', 150, 350, 50), None, {}


def snp_bases():
    seq_alt = 'A' * 10 + 'C' + 'A' * 39
    reads = (make_pair('ref_frag', 100, 300, 50, seq1='A' * 50)
             + make_pair('alt_frag', 100, 300, 50, seq1=seq_alt)
             + make_pair('other_frag', 100, 300, 50,
                         seq1='A' * 10 + 'G' + 'A' * 39)
             + make_pair('both_cover', 100, 105, 50, seq1=seq_alt,
                         seq2='A' * 5 + 'C' + 'A' * 44))
    return reads, [('1', 110, 'A', 'C')], {}


def deletion():
    r1, r2 = make_pair('del_frag', 100, 300, 50)
    r1['cigar'] = [(10, 0), (5, 2), (40, 0)]
    return [r1, r2], [('1', 112, 'A', 'C')], {}


def unchecked_pairs():
    reads, snps, _ = discordant()
    return reads, snps, dict(check_proper_pair=False)


def random_reads(seed=3, n=400):
    """``n`` pairs from a seed: random positions, lengths, bases at a few
    SNPs, soft clips, duplicates, improper pairs and low mapping
    qualities."""
    rng = np.random.RandomState(seed)
    snps = [('1', int(p), 'A', 'C') for p in
            np.unique(rng.randint(0, 40000, 300))]
    reads = []
    for i in range(n):
        pos1 = int(rng.randint(0, 40000))
        pos2 = pos1 + int(rng.randint(0, 400))
        seq1 = ''.join(rng.choice(list('ACGT'), 50))
        seq2 = ''.join(rng.choice(list('AC'), 50))
        r1, r2 = make_pair('frag_{:04d}'.format(i), pos1, pos2, 50,
                           mapq=int(rng.choice([0, 20, 60])), seq1=seq1,
                           seq2=seq2)
        if rng.rand() < 0.05:
            clipped = int(rng.randint(1, 20))
            r1['cigar'] = [(clipped, 4), (50 - clipped, 0)]
        if rng.rand() < 0.05:
            r1['flag'] |= 0x400
        if rng.rand() < 0.05:
            r1['flag'] &= ~0x2
            r2['flag'] &= ~0x2
        reads += [r1, r2]
    return reads, snps, {}


SCENARIOS = {f.__name__: f for f in (simple, discordant, soft_clipped,
                                     duplicate, snp_bases, deletion,
                                     unchecked_pairs, random_reads)}


def batches(reader, size):
    out = []
    while reader.ReadAlignments(size):
        out.append((reader.GetFragmentTable(), reader.GetAlleleTable()))
    return out


@pytest.mark.parametrize('batch_size', [7, 10000])
@pytest.mark.parametrize('scenario', sorted(SCENARIOS))
def test_allele_reader_matches_jax(tmp_path, scenario, batch_size):
    import remixt_tpu.io.bamreader as jax_bamreader
    from remixt_tpu_torch.io import bamreader

    reads, snps, kwargs = SCENARIOS[scenario]()
    bam_path, snp_path = write_inputs(tmp_path, reads, snps)
    args = dict(dict(max_fragment_length=1000, max_soft_clipped=8,
                     check_proper_pair=True), **kwargs)
    ref = batches(jax_bamreader.AlleleReader(bam_path, snp_path, '1',
                                             **args), batch_size)
    got = batches(bamreader.AlleleReader(bam_path, snp_path, '1', **args),
                  batch_size)
    assert len(got) == len(ref) > 0
    assert sum(len(f) for f, _ in got) > 0
    for (fragments, alleles), (ref_fragments, ref_alleles) in zip(got, ref):
        for table, ref_table in ((fragments, ref_fragments),
                                 (alleles, ref_alleles)):
            assert table.columns == list(ref_table.columns)
            for name in table.columns:
                assert table[name].dtype == ref_table[name].dtype, name
                np.testing.assert_array_equal(table[name],
                                              ref_table[name].values, name)


def test_reader_raises_for_a_missing_bam(tmp_path):
    from remixt_tpu_torch.io import bamreader
    with pytest.raises(IOError):
        bamreader.AlleleReader(str(tmp_path / 'none.bam'), '', '1', 1000, 8,
                               True)


@pytest.mark.parametrize('form', ['h5', 'directory'])
def test_create_chromosome_seqdata_matches_jax(tmp_path, form):
    import remixt_tpu.seqdataio as jax_seqdataio
    from remixt_tpu_torch import seqdataio

    reads, snps, _ = random_reads(seed=5)
    bam_path, snp_path = write_inputs(tmp_path, reads, snps)
    args = ('1', 1000, 8, True)
    ref_path = str(tmp_path / 'jax.h5')
    jax_seqdataio.create_chromosome_seqdata(ref_path, bam_path, snp_path,
                                            *args)
    path = str(tmp_path / ('port.h5' if form == 'h5' else 'port'))
    seqdataio.create_chromosome_seqdata(path, bam_path, snp_path, *args)
    assert os.path.isfile(path) == (form == 'h5')

    filters = dict(filter_duplicates=None, map_qual_threshold=None)
    for got, ref in (
            (seqdataio.read_fragment_data(path, '1', **filters),
             jax_seqdataio.read_fragment_data(ref_path, '1', **filters)),
            (seqdataio.read_allele_data(path, '1'),
             jax_seqdataio.read_allele_data(ref_path, '1'))):
        assert len(ref) > 0
        assert got.columns == list(ref.columns)
        for name in got.columns:
            np.testing.assert_array_equal(got[name], ref[name].values, name)
    assert seqdataio.read_chromosomes(path) == \
        jax_seqdataio.read_chromosomes(ref_path) == {'1'}


def test_host_build_is_keyed_by_source_and_raises_on_failure(tmp_path,
                                                             monkeypatch):
    """``build_host`` names its library by a hash of the source, so a
    changed source builds anew, and a failed build raises with the
    compiler's output."""
    from remixt_tpu_torch.ops import _build
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    source = tmp_path / 'probe.cpp'
    source.write_text('extern "C" int probe() { return 1; }\n')
    first = _build.build_host('probe')
    assert first.exists() and _build.build_host('probe') == first
    source.write_text('extern "C" int probe() { return 2; }\n')
    second = _build.build_host('probe')
    assert second != first and second.exists()
    source.write_text('this is not C++\n')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed for probe'):
        _build.build_host('probe')
