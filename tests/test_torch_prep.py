"""The ``run`` path's host modules of the port against the JAX package's,
function by function, on the CPU: ``analysis/stats.py``, ``segment.py``,
``haplotype.py``, ``readcount.py`` and ``gcbias.py``.

The inputs are a small synthetic sample from seeds
(``chip_smoke.make_run_fixture``: two chromosomes of 2 and 1.5 Mb, the
normal at 6×, the tumour at 3×) extracted into seqdata stores; the
phasing tools are ``chip_smoke.write_standin_tools``' stand-ins. Integers
must be equal, floats equal at rtol 1e-12.
"""

import importlib.util
import os
import pickle

import numpy as np
import pandas as pd
import pytest

import remixt_tpu.analysis.gcbias as jax_gcbias
import remixt_tpu.analysis.haplotype as jax_haplotype
import remixt_tpu.analysis.readcount as jax_readcount
import remixt_tpu.analysis.segment as jax_segment
import remixt_tpu.analysis.stats as jax_stats
from remixt_tpu_torch import seqdataio
from remixt_tpu_torch.analysis import (gcbias, haplotype, readcount, segment,
                                       stats)
from remixt_tpu_torch.io.table import Table, read_tsv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHROMOSOMES = {'1': 2000000, '2': 1500000}
CONFIG = dict(segment_length=100000, shapeit_num_samples=8,
              sample_gc_num_positions=50000)


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def sample(tmp_path_factory):
    cs = chip_smoke()
    root = tmp_path_factory.mktemp('torch_prep')
    fixture = cs.make_run_fixture(
        str(root / 'fixture'), CHROMOSOMES,
        depths={'tumour': 3.0, 'normal': 6.0}, with_hdf5=True,
        mixture_params=dict(N=30, num_ancestral_events=8,
                            num_descendent_events=4, num_false_breakpoints=3))
    config = dict(fixture['config'], **CONFIG)
    seqdata = {}
    for name, bam in fixture['bams'].items():
        seqdata[name] = str(root / '{}.h5'.format(name))
        seqdataio.create_seqdata(
            seqdata[name], bam, os.path.join(fixture['ref_data_dir'],
                                             'thousand_genomes_snps.tsv'),
            1000, 8, True, str(root / 'tmp' / name), list(CHROMOSOMES))
    segments = str(root / 'segments.tsv')
    segment.create_segments(segments, config, fixture['ref_data_dir'],
                            breakpoint_filename=fixture['breakpoint_file'])
    return dict(fixture=fixture, config=config, seqdata=seqdata, root=root,
                segments=segments, ref=fixture['ref_data_dir'],
                jax_config=dict(config, mappability_filename=config[
                    'mappability_filename'] + '.h5'),
                bin=cs.write_standin_tools(str(root / 'bin')))


@pytest.fixture
def standins(sample, monkeypatch):
    monkeypatch.setenv('PATH', sample['bin'] + os.pathsep
                       + os.environ['PATH'])


def column(table, name):
    return table[name] if isinstance(table, Table) else table[name].values


def assert_same(got, ref, label='', columns=True):
    """A port Table against a JAX frame (or a TSV path against a TSV
    path): the same columns, integers and strings equal, floats at rtol
    1e-12."""
    if isinstance(got, str):
        got, ref = (pd.read_csv(p, sep='\t', converters={'chromosome': str})
                    for p in (got, ref))
    if columns:
        assert list(got.columns) == list(ref.columns), label
    assert len(got) == len(ref) > 0, label
    for name in ref.columns:
        a, b = column(got, name), column(ref, name)
        if b.dtype.kind == 'f':
            np.testing.assert_allclose(a.astype(float), b, rtol=1e-12,
                                       atol=0, equal_nan=True,
                                       err_msg='{} {}'.format(label, name))
        else:
            assert [str(v) for v in a] == [str(v) for v in b], (label, name)


def both(tmp_path, name):
    return str(tmp_path / ('jax_' + name)), str(tmp_path / ('port_' + name))


# ---------------------------------------------------------------------------
# stats, segment
# ---------------------------------------------------------------------------

def test_calculate_fragment_stats(sample):
    for name, path in sample['seqdata'].items():
        got = stats.calculate_fragment_stats(path, sample['config'])
        ref = jax_stats.calculate_fragment_stats(path, sample['config'])
        np.testing.assert_allclose(got, ref, rtol=1e-12, err_msg=name)


def test_fragment_stats_of_an_empty_store_raise(tmp_path):
    path = str(tmp_path / 'empty')
    seqdataio.Writer(path).close()
    with pytest.raises(ValueError, match='no fragments'):
        stats.calculate_fragment_stats(path, {})


@pytest.mark.parametrize('with_breakpoints', [False, True])
def test_create_segments(sample, tmp_path, with_breakpoints):
    jax_path, path = both(tmp_path, 'segments.tsv')
    breakpoints = (sample['fixture']['breakpoint_file'] if with_breakpoints
                   else None)
    jax_segment.create_segments(jax_path, sample['config'], sample['ref'],
                                breakpoint_filename=breakpoints)
    segment.create_segments(path, sample['config'], sample['ref'],
                            breakpoint_filename=breakpoints)
    assert_same(path, jax_path)


def test_create_segments_drops_unconfigured_chromosomes(tmp_path):
    """The JAX package's own case: a gap table with chromosome Y."""
    import gzip
    fai = tmp_path / 'genome.fa.fai'
    fai.write_text('1\t30000\t0\t60\t61\n2\t20000\t0\t60\t61\n'
                   'Y\t10000\t0\t60\t61\n')
    gap = tmp_path / 'gaps.txt.gz'
    with gzip.open(gap, 'wt') as f:
        f.write('0\t1\t5000\t6000\t0\tN\t1000\ttelomere\tno\n')
        f.write('0\tY\t2000\t3000\t0\tN\t1000\ttelomere\tno\n')
    config = {'chromosomes': ['1', '2'], 'segment_length': 10000,
              'gap_table_filename': str(gap),
              'genome_fai_filename': str(fai)}
    jax_path, path = both(tmp_path, 'segments.tsv')
    jax_segment.create_segments(jax_path, config, str(tmp_path))
    segment.create_segments(path, config, str(tmp_path))
    assert_same(path, jax_path)
    assert set(read_tsv(path, str_columns=('chromosome',))['chromosome']) \
        == {'1', '2'}


def test_create_segment_counts(sample):
    segments = pd.read_csv(sample['segments'], sep='\t',
                           converters={'chromosome': str})
    for flags in (dict(), dict(filter_duplicates=True, map_qual_threshold=30)):
        ref = jax_segment.create_segment_counts(
            segments, sample['seqdata']['tumour'], **flags)
        got = segment.create_segment_counts(
            read_tsv(sample['segments'], str_columns=('chromosome',)),
            sample['seqdata']['tumour'], **flags)
        assert_same(got, ref, str(flags))


def test_create_segment_allele_counts():
    rng = np.random.RandomState(4)
    segments = pd.DataFrame({'chromosome': ['1'] * 6 + ['2'] * 4,
                             'start': np.arange(10) * 100,
                             'end': np.arange(10) * 100 + 100,
                             'readcount': rng.randint(0, 50, 10) * 1.0})
    rows = rng.randint(0, 9, 30)
    alleles = pd.DataFrame({
        'chromosome': segments['chromosome'].values[rows],
        'start': segments['start'].values[rows],
        'end': segments['end'].values[rows],
        'hap_label': rng.randint(0, 3, 30),
        'allele_id': rng.randint(0, 2, 30),
        'readcount': rng.randint(1, 20, 30),
        'is_allele_a': rng.randint(0, 2, 30)})
    ref = jax_segment.create_segment_allele_counts(segments, alleles)
    got = segment.create_segment_allele_counts(
        Table([(c, segments[c].values) for c in segments.columns]),
        Table([(c, alleles[c].values) for c in alleles.columns]))
    assert_same(got, ref)


# ---------------------------------------------------------------------------
# haplotype
# ---------------------------------------------------------------------------

def test_infer_snp_genotype_posteriors():
    rng = np.random.RandomState(0)
    ref_count, alt_count = rng.randint(0, 30, 500), rng.randint(0, 30, 500)
    frame = pd.DataFrame({'ref_count': ref_count, 'alt_count': alt_count})
    table = Table([('ref_count', ref_count), ('alt_count', alt_count)])
    jax_haplotype.infer_snp_genotype(frame, 0.01, 0.9)
    haplotype.infer_snp_genotype(table, 0.01, 0.9)
    assert_same(table, frame)


def test_read_snp_counts(sample):
    for chromosome in CHROMOSOMES:
        for path in sample['seqdata'].values():
            assert_same(haplotype.read_snp_counts(path, chromosome,
                                                  num_rows=1000),
                        jax_haplotype.read_snp_counts(path, chromosome,
                                                      num_rows=1000))


@pytest.mark.parametrize('source', ['normal', 'tumour'])
def test_infer_snp_genotype(sample, tmp_path, source):
    jax_path, path = both(tmp_path, 'genotypes.tsv')
    if source == 'normal':
        args = (sample['seqdata']['normal'], '1', sample['config'])
        jax_haplotype.infer_snp_genotype_from_normal(jax_path, *args)
        haplotype.infer_snp_genotype_from_normal(path, *args)
    else:
        # pooled counts above 50 reads a position: two deep stores
        stores = {}
        for seed in (1, 2):
            rng = np.random.RandomState(seed)
            depth = rng.randint(20, 80, 300)
            position = np.repeat(np.arange(300) * 7 + 1, depth)
            alt_share = np.repeat(rng.choice([0.0, 0.01, 0.5, 1.0], 300),
                                  depth)
            stores[seed] = str(tmp_path / 'deep{}'.format(seed))
            writer = seqdataio.Writer(stores[seed])
            writer.write('1', Table([(c, np.zeros(0, dtype=int)) for c in (
                'fragment_id', 'start', 'end')]), Table([
                    ('fragment_id', np.arange(len(position))),
                    ('position', position),
                    ('is_alt', (rng.rand(len(position)) < alt_share)
                     .astype(int))]))
            writer.close()
        args = (stores, '1', sample['config'])
        jax_args = ({k: v + '.h5' for k, v in stores.items()}, '1',
                    sample['config'])
        for seed, store in stores.items():
            seqdataio.merge_seqdata(store + '.h5', {seed: store})
        jax_haplotype.infer_snp_genotype_from_tumour(jax_path, *jax_args)
        haplotype.infer_snp_genotype_from_tumour(path, *args)
    assert_same(path, jax_path)


def phasing_samples(seed, n_sites=300, num_samples=12):
    rng = np.random.RandomState(seed)
    chromosome = np.repeat(['chr1', 'chr2'], [200, n_sites - 200])
    position = np.concatenate([np.sort(rng.choice(10 ** 6, 200, False)),
                               np.sort(rng.choice(10 ** 6, n_sites - 200,
                                                  False))])
    truth = rng.randint(0, 2, n_sites)
    # homozygous sites, the same in every draw, which the consensus skips
    hom = rng.rand(n_sites) < 0.1
    samples = []
    for _ in range(num_samples):
        switch = np.cumsum((rng.rand(n_sites) < 0.02)
                           | (np.arange(n_sites) % 50 == 49)
                           & (rng.rand(n_sites) < 0.4)) % 2
        allele1 = truth ^ switch
        samples.append(pd.DataFrame({
            'chromosome': chromosome, 'position': position,
            'ref': 'A', 'alt': 'C', 'allele1': allele1,
            'allele2': np.where(hom, allele1, 1 - allele1)}))
    return samples


def test_calculate_haplotypes():
    samples = phasing_samples(2)
    ref = jax_haplotype.calculate_haplotypes(
        (s.set_index(['chromosome', 'position', 'ref', 'alt'])
         for s in samples), 0.9)
    got = haplotype.calculate_haplotypes(
        (Table([(c, s[c].values) for c in s.columns]) for s in samples), 0.9)
    assert_same(got, ref)
    assert len(np.unique(got['hap_label'])) > 2


def test_infer_haps_grch38_shapeit4(sample, tmp_path, standins):
    """The shapeit4 phasing through the stand-in tools, on the normal's
    genotype calls; the draws' consensus has more than one block."""
    genotypes = str(tmp_path / 'genotypes.tsv')
    haplotype.infer_snp_genotype_from_normal(
        genotypes, sample['seqdata']['normal'], '1', sample['config'])
    jax_path, path = both(tmp_path, 'haps.tsv')
    jax_haplotype.infer_haps_grch38_shapeit4(
        jax_path, genotypes, '1', str(tmp_path / 'jax_tmp'),
        sample['config'], sample['ref'])
    haplotype.infer_haps(path, genotypes, '1', str(tmp_path / 'port_tmp'),
                         sample['config'], sample['ref'])
    assert_same(path, jax_path)
    haps = read_tsv(path, str_columns=('chromosome',))
    assert len(np.unique(haps['hap_label'])) > 1
    assert set(haps['chromosome']) == {'1'}


def test_read_bcf_phased_genotypes(tmp_path, standins):
    path = tmp_path / 'sample.bcf'
    path.write_text('##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t'
                    'FILTER\tINFO\tFORMAT\tNORMAL\n'
                    'chr1\t10\t.\tA\tC\t.\t.\t.\tGT\t0|1\n'
                    'chr1\t20\t.\tG\tT,C\t.\t.\t.\tGT:DP\t1/0:5\n')
    assert_same(haplotype.read_bcf_phased_genotypes(str(path)),
                jax_haplotype.read_bcf_phased_genotypes(str(path)))


def test_infer_haps_rejects_bad_chr_prefix(sample, tmp_path):
    config = dict(sample['config'], chr_name_prefix='ch')
    with pytest.raises(ValueError, match='chr_name_prefix'):
        haplotype.infer_haps_grch38_shapeit4(
            str(tmp_path / 'haps.tsv'), str(tmp_path / 'g.tsv'), '1',
            str(tmp_path / 'tmp'), config, sample['ref'])


# ---------------------------------------------------------------------------
# GRCh37: shapeit2
# ---------------------------------------------------------------------------

GRCH37 = dict(ensembl_genome_version='GRCh37')


def panel_rows(ref, chromosome):
    """The reference's SNP panel rows of one chromosome: 1-based position,
    ref and alt bases."""
    rows = [line.rstrip('\n').split('\t') for line in
            open(os.path.join(ref, 'thousand_genomes_snps.tsv'))]
    rows = [r for r in rows if r[0] == chromosome]
    return (np.array([int(r[1]) for r in rows]), [r[2] for r in rows],
            [r[3] for r in rows])


@pytest.fixture(scope='module')
def grch37(sample, tmp_path_factory):
    """The sample's reference with a GRCh37 impute2 panel (legend,
    haplotypes, genetic map, sample file) for chromosomes 1 and 2 and for
    X_nonPAR, and the normal's genotype calls of chromosome 1; X is
    chromosome 1's SNPs and calls under the name X, its truth chromosome
    1's."""
    import shutil
    cs = chip_smoke()
    ref = sample['ref']
    panel = os.path.join(ref, 'ALL_1000G_phase1integrated_v3_impute')
    rng = np.random.RandomState(5)
    for chromosome, panel_chromosome in (('1', '1'), ('2', '2'),
                                         ('1', 'X_nonPAR')):
        position, a0, a1 = panel_rows(ref, chromosome)
        cs.write_impute_panel(panel, panel_chromosome, position, a0, a1, 10,
                              rng)
    cs.write_panel_sample(panel, 10)
    shutil.copy(cs.panel_truth_path(ref, '1'), cs.panel_truth_path(ref, 'X'))
    genotypes = str(tmp_path_factory.mktemp('grch37') / 'genotypes.tsv')
    haplotype.infer_snp_genotype_from_normal(
        genotypes, sample['seqdata']['normal'], '1', sample['config'])
    return dict(genotypes=genotypes, config=dict(sample['config'], **GRCH37))


def infer_both(sample, config, genotypes, chromosome, tmp_path):
    """Both packages' ``infer_haps`` on the same inputs; returns the paths
    of their haps TSVs and temporary directories."""
    jax_path, path = both(tmp_path, 'haps.tsv')
    jax_tmp, tmp = both(tmp_path, 'tmp')
    jax_haplotype.infer_haps(jax_path, genotypes, chromosome, jax_tmp,
                             config, sample['ref'])
    haplotype.infer_haps(path, genotypes, chromosome, tmp, config,
                         sample['ref'])
    return dict(jax=jax_path, port=path, jax_tmp=jax_tmp, tmp=tmp)


def graph_argv(tmp):
    """The graph call's argv as the shapeit stand-in logged it, with the
    temporary directory's path cut out."""
    with open(os.path.join(tmp, 'phased.hgraph.log')) as f:
        return f.read().replace(tmp, 'TMP')


def test_infer_haps_grch37_shapeit2(sample, grch37, tmp_path, standins):
    """Chromosome 1 through the shapeit stand-in: the haps TSV is the JAX
    package's, with more than one block; the graph call's argv is the
    JAX package's, and every draw's files are gone."""
    out = infer_both(sample, grch37['config'], grch37['genotypes'], '1',
                     tmp_path)
    assert_same(out['port'], out['jax'])
    haps = read_tsv(out['port'], str_columns=('chromosome',))
    assert len(np.unique(haps['hap_label'])) > 1
    assert set(haps['chromosome']) == {'1'}
    argv = graph_argv(out['tmp'])
    assert argv == graph_argv(out['jax_tmp'])
    assert '--chrX' not in argv and argv.endswith('--seed 12345\n')
    assert sorted(os.listdir(out['tmp'])) == [
        'phased.hgraph', 'phased.hgraph.log', 'snps.gen', 'snps.sample']


def test_infer_haps_grch37_female_x(sample, grch37, tmp_path, standins):
    """A female X phases through the X_nonPAR panel with --chrX in the
    graph call, as the JAX package does."""
    genotypes = str(tmp_path / 'genotypes_x.tsv')
    open(genotypes, 'w').write(open(grch37['genotypes']).read())
    out = infer_both(sample, dict(grch37['config'], is_female=True),
                     genotypes, 'X', tmp_path)
    assert_same(out['port'], out['jax'])
    haps = read_tsv(out['port'], str_columns=('chromosome',))
    assert set(haps['chromosome']) == {'X'}
    argv = graph_argv(out['tmp'])
    assert argv == graph_argv(out['jax_tmp'])
    assert ' --chrX ' in argv
    assert 'genetic_map_chrX_nonPAR_combined_b37.txt' in argv
    assert 'chrX_nonPAR_impute.hap.gz' in argv
    assert 'chrX_nonPAR_impute.legend.gz' in argv


@pytest.mark.parametrize('chromosome, is_female', [('X', False),
                                                   ('Y', True)],
                         ids=['male X', 'non-phasable'])
def test_infer_haps_grch37_null(sample, grch37, tmp_path, chromosome,
                                is_female):
    """A male X and a chromosome outside 1-22 and X get null haps, as in
    the JAX package; no tool is called."""
    out = infer_both(sample, dict(grch37['config'], is_female=is_female),
                     grch37['genotypes'], chromosome, tmp_path)
    text = open(out['port']).read()
    assert text == open(out['jax']).read()
    assert text == '\t'.join(haplotype.HAPS_COLUMNS) + '\n'
    assert not os.path.exists(out['tmp'])


def test_infer_haps_grch37_no_genotype(sample, grch37, tmp_path, standins):
    """A genotype table with no row gives null haps in both packages."""
    genotypes = str(tmp_path / 'genotypes.tsv')
    open(genotypes, 'w').write('position\tAA\tAB\tBB\n')
    out = infer_both(sample, grch37['config'], genotypes, '1', tmp_path)
    text = open(out['port']).read()
    assert text == open(out['jax']).read()
    assert text == '\t'.join(haplotype.HAPS_COLUMNS) + '\n'


def test_infer_haps_grch37_no_called_genotype(sample, grch37, tmp_path,
                                              standins):
    """Rows, but none called: the port stages nothing, calls no tool and
    writes null haps. The JAX package stages an empty .gen and calls
    shapeit on it, which the stand-in, like the tool, refuses."""
    import subprocess
    genotypes = str(tmp_path / 'genotypes.tsv')
    table = read_tsv(grch37['genotypes'])
    with open(genotypes, 'w') as f:
        f.write('position\tAA\tAB\tBB\n')
        f.writelines('{}\t0\t0\t0\n'.format(p)
                     for p in table['position'].tolist())
    path = str(tmp_path / 'haps.tsv')
    haplotype.infer_haps(path, genotypes, '1', str(tmp_path / 'tmp'),
                         grch37['config'], sample['ref'])
    assert open(path).read() == '\t'.join(haplotype.HAPS_COLUMNS) + '\n'
    assert os.listdir(str(tmp_path / 'tmp')) == []
    with pytest.raises(subprocess.CalledProcessError):
        jax_haplotype.infer_haps(str(tmp_path / 'jax_haps.tsv'), genotypes,
                                 '1', str(tmp_path / 'jax_tmp'),
                                 grch37['config'], sample['ref'])


def failing_convert(run, failures):
    """``_run`` with its first ``failures`` shapeit -convert calls failing
    as a crashed tool fails."""
    import subprocess
    count = [0]

    def wrapped(*args):
        if list(args[:2]) == ['shapeit', '-convert'] and count[0] < failures:
            count[0] += 1
            raise subprocess.CalledProcessError(-11, [str(a) for a in args])
        return run(*args)
    return wrapped


@pytest.mark.parametrize('failures', [1, 3], ids=['once', 'every time'])
def test_infer_haps_grch37_retries_convert(sample, grch37, tmp_path,
                                           standins, monkeypatch, failures):
    """A -convert that fails once is retried and gives the JAX package's
    haps; one that fails three times raises in both, naming the seed."""
    for module in (jax_haplotype, haplotype):
        monkeypatch.setattr(module, '_run',
                            failing_convert(module._run, failures))
    if failures == 1:
        out = infer_both(sample, grch37['config'], grch37['genotypes'], '1',
                         tmp_path)
        assert_same(out['port'], out['jax'])
        return
    for module in (jax_haplotype, haplotype):
        with pytest.raises(Exception, match='3 times with seed 0'):
            module.infer_haps(str(tmp_path / 'haps.tsv'),
                              grch37['genotypes'], '1',
                              str(tmp_path / module.__name__),
                              grch37['config'], sample['ref'])


def test_stage_shapeit2_inputs_byte_for_byte(tmp_path):
    """The staged .gen and .sample equal the JAX package's byte for byte on
    a legend with a multi-base row, a non-ACGT row, a repeated position,
    a row outside the calls, and homozygous and uncalled genotypes."""
    import gzip
    legend = str(tmp_path / 'legend.gz')
    with gzip.open(legend, 'wt') as f:
        f.write('id position a0 a1 type\n'
                'rs1 100 A C SNP\n'
                'rs2 200 AT A INDEL\n'
                'rs3 300 G N SNP\n'
                'rs4 400 T G SNP\n'
                'rs4b 400 T C SNP\n'
                'rs5 500 C A SNP\n'
                'rs6 600 G T SNP\n'
                'rs7 700 A G SNP\n')
    genotypes = str(tmp_path / 'genotypes.tsv')
    with open(genotypes, 'w') as f:
        f.write('position\tAA\tAB\tBB\n100\t0\t1\t0\n200\t0\t1\t0\n'
                '300\t1\t0\t0\n400\t0\t1\t0\n500\t1\t0\t0\n'
                '600\t0\t0\t0\n700\t0\t0\t1\n800\t0\t1\t0\n')
    files = {}
    for name, module in (('jax', jax_haplotype), ('port', haplotype)):
        tmp = tmp_path / name
        tmp.mkdir()
        files[name] = module._stage_shapeit2_inputs(genotypes, legend, '7',
                                                    str(tmp))
    for jax_file, port_file in zip(files['jax'], files['port']):
        assert open(port_file, 'rb').read() == open(jax_file, 'rb').read()
    gen = open(files['port'][0]).read().splitlines()
    assert gen == ['7 7:100 100 A C 0 1 0', '7 7:400 400 T G 0 1 0',
                   '7 7:400 400 T C 0 1 0', '7 7:500 500 C A 1 0 0',
                   '7 7:700 700 A G 0 0 1']


def test_infer_haps_unknown_build_raises(sample, tmp_path):
    config = dict(sample['config'], ensembl_genome_version='GRCh36')
    for module in (jax_haplotype, haplotype):
        with pytest.raises(ValueError, match='GRCh36'):
            module.infer_haps(str(tmp_path / 'haps.tsv'),
                              str(tmp_path / 'g.tsv'), '1',
                              str(tmp_path / 'tmp'), config, sample['ref'])


def draws_of(kind, seed=3):
    """(position, allele1) of three draws: the same het positions in each,
    the middle draw lacking some, or the last draw lacking some."""
    rng = np.random.RandomState(seed)
    position = np.sort(rng.choice(10 ** 6, 60, replace=False)) + 1
    fewer = np.sort(rng.choice(60, 45, replace=False))
    keep = {'same': [None, None, None], 'middle lacks': [None, fewer, None],
            'last lacks': [None, None, fewer]}[kind]
    draws = []
    for rows in keep:
        rows = np.arange(60) if rows is None else rows
        allele = np.cumsum(rng.rand(60) < 0.1) % 2
        draws.append((position[rows], allele[rows]))
    return draws


@pytest.mark.parametrize('kind', ['same', 'middle lacks', 'last lacks'])
def test_infer_haps_grch37_draws_of_different_sites(sample, grch37, tmp_path,
                                                    standins, monkeypatch,
                                                    kind):
    """The flips of the draws summed as the JAX code sums its
    position-indexed series: where a draw lacks a position the sum is NaN
    there, which splits no block; where the last draw lacks one, both
    raise."""
    draws = draws_of(kind)
    monkeypatch.setattr(
        jax_haplotype, '_sample_shapeit2_phasing',
        lambda graph, prefix, seed: pd.Series(
            draws[seed][1], index=pd.Index(draws[seed][0], name='position'),
            name='allele'))
    monkeypatch.setattr(haplotype, '_sample_shapeit2_phasing',
                        lambda graph, prefix, seed: draws[seed])
    config = dict(grch37['config'], shapeit_num_samples=3,
                  shapeit_confidence_threshold=0.9)
    if kind == 'last lacks':
        for module in (jax_haplotype, haplotype):
            with pytest.raises(ValueError):
                module.infer_haps(str(tmp_path / 'haps.tsv'),
                                  grch37['genotypes'], '1',
                                  str(tmp_path / module.__name__), config,
                                  sample['ref'])
        return
    out = infer_both(sample, config, grch37['genotypes'], '1', tmp_path)
    assert_same(out['port'], out['jax'])
    assert len(np.unique(read_tsv(out['port'])['hap_label'])) > 1


@pytest.fixture(scope='module')
def haps(sample, tmp_path_factory):
    """The phased haplotypes of both chromosomes through the stand-ins."""
    tmp = tmp_path_factory.mktemp('haps')
    path = os.environ['PATH']
    os.environ['PATH'] = sample['bin'] + os.pathsep + path
    try:
        files = []
        for chromosome in CHROMOSOMES:
            genotypes = str(tmp / 'g{}.tsv'.format(chromosome))
            haplotype.infer_snp_genotype_from_normal(
                genotypes, sample['seqdata']['normal'], chromosome,
                sample['config'])
            files.append(str(tmp / 'h{}.tsv'.format(chromosome)))
            haplotype.infer_haps(files[-1], genotypes, chromosome,
                                 str(tmp / chromosome), sample['config'],
                                 sample['ref'])
    finally:
        os.environ['PATH'] = path
    merged = str(tmp / 'haps.tsv')
    from remixt_tpu_torch import utils
    utils.merge_tables(merged, *files)
    return merged


@pytest.mark.parametrize('flags', [{}, dict(filter_duplicates=True,
                                            map_qual_threshold=30)],
                         ids=['defaults', 'filtered'])
def test_count_allele_reads(sample, haps, flags):
    segments = pd.read_csv(sample['segments'], sep='\t',
                           converters={'chromosome': str})
    hap_table = pd.read_csv(haps, sep='\t', converters={'chromosome': str})
    port_haps = read_tsv(haps, str_columns=('chromosome',))
    port_segments = read_tsv(sample['segments'], str_columns=('chromosome',))
    for chromosome in CHROMOSOMES:
        ref = jax_haplotype.count_allele_reads(
            sample['seqdata']['tumour'], hap_table, chromosome,
            segments[segments['chromosome'] == chromosome].copy(), **flags)
        got = haplotype.count_allele_reads(
            sample['seqdata']['tumour'], port_haps, chromosome,
            port_segments.take(port_segments['chromosome'] == chromosome),
            **flags)
        assert_same(got, ref, chromosome)


def test_create_allele_counts(sample, haps):
    segments = pd.read_csv(sample['segments'], sep='\t',
                           converters={'chromosome': str})
    ref = jax_haplotype.create_allele_counts(
        segments, sample['seqdata']['tumour'], haps)
    got = haplotype.create_allele_counts(
        read_tsv(sample['segments'], str_columns=('chromosome',)),
        sample['seqdata']['tumour'], haps)
    assert_same(got, ref)


def allele_counts_tables(seed, num_libraries=3):
    """Allele count tables of a few libraries over shared segments and
    blocks, with ties and blocks that only some libraries have."""
    rng = np.random.RandomState(seed)
    tables = []
    for _ in range(num_libraries):
        rows = []
        for seg in range(12):
            for label in range(3):
                for allele_id in (0, 1):
                    if rng.rand() < 0.8:
                        rows.append(('1' if seg < 8 else '2', seg * 100,
                                     seg * 100 + 100, label, allele_id,
                                     int(rng.choice([0, 3, 5, 5, 9]))))
        tables.append(pd.DataFrame(rows, columns=[
            'chromosome', 'start', 'end', 'hap_label', 'allele_id',
            'readcount']))
    return tables


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_phase_segments(seed):
    frames = allele_counts_tables(seed)
    ref = jax_haplotype.phase_segments(*frames)
    got = haplotype.phase_segments(*(Table([(c, f[c].values)
                                            for c in f.columns])
                                     for f in frames))
    for g, r in zip(got, ref):
        assert_same(g, r.reset_index(drop=True))


# ---------------------------------------------------------------------------
# readcount: the task wrappers
# ---------------------------------------------------------------------------

def test_readcount_tasks(sample, haps, tmp_path):
    segment_counts = both(tmp_path, 'segment_counts.tsv')
    allele_counts = both(tmp_path, 'allele_counts.tsv')
    phased = both(tmp_path, 'phased.tsv')
    counts = both(tmp_path, 'counts.tsv')
    for k, module in enumerate((jax_readcount, readcount)):
        module.segment_readcount(segment_counts[k], sample['segments'],
                                 sample['seqdata']['tumour'],
                                 sample['config'])
        module.haplotype_allele_readcount(
            allele_counts[k], sample['segments'],
            sample['seqdata']['tumour'], haps, sample['config'])
        module.phase_segments({'t': allele_counts[k]}, {'t': phased[k]})
        module.prepare_readcount_table(segment_counts[k], phased[k],
                                       counts[k])
    for pair in (segment_counts, allele_counts, phased, counts):
        assert_same(pair[1], pair[0], os.path.basename(pair[1]))


# ---------------------------------------------------------------------------
# gcbias
# ---------------------------------------------------------------------------

def test_lowess():
    rng = np.random.RandomState(1)
    x = np.arange(101, dtype=float)
    y = np.exp(-((x - 45) / 20) ** 2) + 0.05 * rng.randn(101)
    np.testing.assert_allclose(gcbias.lowess(y, x, frac=0.2),
                               jax_gcbias.lowess(y, x, frac=0.2), rtol=1e-12)


@pytest.mark.parametrize('form', ['h5', 'directory'])
def test_read_mappability_indicator(sample, form):
    store = sample['config']['mappability_filename']
    store = store + '.h5' if form == 'h5' else store
    for chromosome, length in CHROMOSOMES.items():
        got = gcbias.read_mappability_indicator(store, chromosome, length, 1)
        ref = jax_gcbias.read_mappability_indicator(
            store + ('' if form == 'h5' else '.h5'), chromosome, length, 1)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        assert 0 < got.mean() < 1


@pytest.mark.parametrize('with_fai', [True, False])
def test_read_gc_cumsum(sample, tmp_path, with_fai):
    fasta = sample['config']['genome_fasta_filename']
    if not with_fai:
        os.symlink(fasta, str(tmp_path / 'genome.fa'))
        fasta = str(tmp_path / 'genome.fa')
    for chromosome in CHROMOSOMES:
        got = gcbias.read_gc_cumsum(fasta, chromosome)
        ref = jax_gcbias.read_gc_cumsum(fasta, chromosome)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_sample_gc_seeded(sample, tmp_path):
    """``np.random.seed(s)`` before the JAX call and ``RandomState(s)``
    for the port draw the same positions; the default draws from numpy's
    global state, as the JAX package does."""
    jax_path, path = both(tmp_path, 'gcsamples.tsv')
    np.random.seed(7)
    jax_gcbias.sample_gc(jax_path, sample['seqdata']['tumour'], 300.7,
                         sample['jax_config'], sample['ref'])
    gcbias.sample_gc(path, sample['seqdata']['tumour'], 300.7,
                     sample['config'], sample['ref'],
                     rng=np.random.RandomState(7))
    got = pd.read_csv(path, sep='\t', header=None)
    ref = pd.read_csv(jax_path, sep='\t', header=None)
    assert_same(got, ref)
    assert got[3].sum() > 0
    np.random.seed(7)
    default = str(tmp_path / 'default.tsv')
    gcbias.sample_gc(default, sample['seqdata']['tumour'], 300.7,
                     sample['config'], sample['ref'])
    assert_same(pd.read_csv(default, sep='\t', header=None), ref)


@pytest.fixture(scope='module')
def gc_curve(sample, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('gc')
    samples = str(tmp / 'gcsamples.tsv')
    gcbias.sample_gc(samples, sample['seqdata']['tumour'], 300,
                     sample['config'], sample['ref'],
                     rng=np.random.RandomState(3))
    return samples, tmp


def test_gc_lowess(gc_curve):
    samples, tmp = gc_curve
    outputs = [(str(tmp / (p + 'dist.tsv')), str(tmp / (p + 'table.tsv')))
               for p in ('jax_', 'port_')]
    jax_gcbias.gc_lowess(samples, *outputs[0])
    gcbias.gc_lowess(samples, *outputs[1])
    assert_same(outputs[1][1], outputs[0][1])
    np.testing.assert_allclose(np.loadtxt(outputs[1][0]),
                               np.loadtxt(outputs[0][0]), rtol=1e-12)
    curve_jax, curve = jax_gcbias.GCCurve(), gcbias.GCCurve()
    curve_jax.read(outputs[0][0])
    curve.read(outputs[1][0])
    for length in (100, 292, 350):
        np.testing.assert_allclose(curve.table(length),
                                   curve_jax.table(length), rtol=1e-12)
    assert curve.predict(0.41) == curve_jax.predict(0.41)


def test_gc_map_bias_and_biased_length(sample, gc_curve, tmp_path):
    samples, tmp = gc_curve
    dist = str(tmp / 'dist.tsv')
    jax_gcbias.gc_lowess(samples, dist, str(tmp / 'table.tsv'))
    counts = str(tmp_path / 'counts.tsv')
    readcount.segment_readcount(counts, sample['segments'],
                                sample['seqdata']['tumour'],
                                sample['config'])
    mean, stddev = stats.calculate_fragment_stats(
        sample['seqdata']['tumour'], sample['config'])
    bias = both(tmp_path, 'bias.tsv')
    length = both(tmp_path, 'length.tsv')
    jax_gcbias.gc_map_bias(counts, mean, stddev, dist, bias[0],
                           sample['jax_config'], sample['ref'])
    gcbias.gc_map_bias(counts, mean, stddev, dist, bias[1],
                       sample['config'], sample['ref'])
    assert_same(bias[1], bias[0])
    jax_gcbias.biased_length(length[0], bias[0])
    gcbias.biased_length(length[1], bias[0])
    assert_same(length[1], length[0])


def test_calculate_segment_gc_map_bias(sample, gc_curve, tmp_path):
    import scipy.stats
    samples, tmp = gc_curve
    dist = str(tmp / 'dist2.tsv')
    gcbias.gc_lowess(samples, dist, str(tmp / 'table2.tsv'))
    curve_jax, curve = jax_gcbias.GCCurve(), gcbias.GCCurve()
    curve_jax.read(dist)
    curve.read(dist)
    cumsum = gcbias.read_gc_cumsum(sample['config']['genome_fasta_filename'],
                                   '1')
    mappable = gcbias.read_mappability_indicator(
        sample['config']['mappability_filename'], '1', len(cumsum), 1)
    dist_f = scipy.stats.norm(300, 30)
    for do_gc, do_map in ((True, True), (True, False), (False, True)):
        args = (cumsum[200000:300000], mappable[200000:300000])
        kwargs = dict(do_gc=do_gc, do_map=do_map)
        np.testing.assert_allclose(
            gcbias.calculate_segment_gc_map_bias(
                *args, curve, dist_f, 229, 371, 10, 4, 100, **kwargs),
            jax_gcbias.calculate_segment_gc_map_bias(
                *args, curve_jax, dist_f, 229, 371, 10, 4, 100, **kwargs),
            rtol=1e-12)
