"""The port's read-level simulation (``remixt_tpu_torch.simulations.
{seqread,haplotype}`` and the germline allele store) against the JAX
package's, on the CPU.

The genome is ``tests/test_seqread.py``'s small one (2 Mb, 2 chromosomes,
seed 17) with its SNPs; the impute2 panel is ``chip_smoke.
write_impute_panel``'s, a few hundred rows with indels among them. The same
seed gives the same fragments, alleles and germline alleles: every column
exact (tolerance 0), the seqdata in both store forms (HDF5 and ``.npy``
directory).
"""

import importlib.util
import os

import numpy as np
import pandas as pd
import pytest

import remixt_tpu.seqdataio as jax_seqdataio
import remixt_tpu.simulations.genome as jax_genome
import remixt_tpu.simulations.haplotype as jax_haplotype
import remixt_tpu.simulations.pipeline as jax_pipeline
import remixt_tpu.simulations.seqread as jax_seqread
from remixt_tpu_torch import seqdataio as torch_seqdataio
from remixt_tpu_torch.io.table import Table
from remixt_tpu_torch.simulations import genome as torch_genome
from remixt_tpu_torch.simulations import haplotype as torch_haplotype
from remixt_tpu_torch.simulations import pipeline as torch_pipeline
from remixt_tpu_torch.simulations import seqread as torch_seqread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAMS = {
    'read_length': 50,
    'fragment_mean': 200.,
    'fragment_stddev': 20.,
    'base_call_error': 0.05,
}
FORMS = ['h5', 'dir']


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class SnpsAccessor(dict):
    def __getitem__(self, key):
        return dict.__getitem__(self, key.split('chromosome_')[-1])


def genome_params():
    return dict(jax_genome.RearrangedGenome.default_params,
                genome_length=2e6, num_chromosomes=2, seg_length_min=5000)


@pytest.fixture(scope='module')
def genomes():
    """(JAX genomes, port genomes): test_seqread.py's small genome and a
    copy rearranged further, from the same seeds."""
    params = dict(jax_genome.RearrangedGenome.default_params)
    np.random.seed(17)
    jax_g = jax_genome.RearrangedGenome(30)
    jax_g.create(genome_params())
    for _ in range(5):
        jax_g.rearrange(params)
    jax_h = jax_g.copy()
    for _ in range(3):
        jax_h.rearrange(params)

    rng = np.random.RandomState(17)
    torch_g = torch_genome.RearrangedGenome(30)
    torch_g.create(genome_params(), rng)
    for _ in range(5):
        torch_g.rearrange(params, rng)
    torch_h = torch_g.copy()
    for _ in range(3):
        torch_h.rearrange(params, rng)
    return [jax_g, jax_h], [torch_g, torch_h]


@pytest.fixture(scope='module')
def snps(genomes):
    """(JAX accessor of DataFrames, port accessor of Tables): a SNP every
    500 bases, random germline states (test_seqread.py's make_snps)."""
    genome = genomes[0][0]
    rng = np.random.RandomState(3)
    jax_snps, torch_snps = SnpsAccessor(), SnpsAccessor()
    for chromosome in np.unique(genome.segment_chromosome_id):
        length = int(genome.segment_end[
            genome.segment_chromosome_id == chromosome].max())
        positions = np.arange(250, length, 500)
        columns = {'position': positions,
                   'is_alt_0': rng.randint(2, size=len(positions)),
                   'is_alt_1': rng.randint(2, size=len(positions))}
        jax_snps[chromosome] = pd.DataFrame(columns)
        torch_snps[chromosome] = Table(columns)
    return jax_snps, torch_snps


def store_path(tmp_path, name, form):
    return str(tmp_path / (name + '.h5' if form == 'h5' else name))


def assert_same_seqdata(got_file, ref_file):
    """Every chromosome's fragment and allele columns equal, exactly."""
    chromosomes = jax_seqdataio.read_chromosomes(ref_file)
    assert torch_seqdataio.read_chromosomes(got_file) == chromosomes
    assert chromosomes
    for chromosome in chromosomes:
        for record_type in ('fragments', 'alleles'):
            ref = jax_seqdataio.read_seq_data(ref_file, record_type,
                                              chromosome)
            got = torch_seqdataio.read_seq_data(got_file, record_type,
                                                chromosome)
            assert got.columns == list(ref.columns), record_type
            assert len(got) > 0, (chromosome, record_type)
            for name in ref.columns:
                np.testing.assert_array_equal(
                    got[name], ref[name].values,
                    err_msg='{} {} {}'.format(chromosome, record_type, name))


def test_segment_remap_equals_jax():
    rng = np.random.RandomState(0)
    lengths = rng.randint(1, 100, 50)
    starts = np.cumsum(rng.randint(0, 30, 50) + np.r_[0, lengths[:-1]])
    segments = np.stack([starts, starts + lengths], axis=1)
    positions = rng.randint(0, lengths.sum(), 500)
    for got, ref in zip(torch_seqread.segment_remap(segments, positions),
                        jax_seqread.segment_remap(segments, positions)):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        torch_seqread.segment_remap(segments,
                                    np.array([lengths.sum() + 1]))


def test_simulate_fragment_intervals_equals_jax():
    np.random.seed(4)
    ref = jax_seqread.simulate_fragment_intervals(
        np.int64(10 ** 6), 5000, 50, 200., 20.)
    got = torch_seqread.simulate_fragment_intervals(
        np.int64(10 ** 6), 5000, 50, 200., 20., np.random.RandomState(4))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype


@pytest.mark.parametrize('form', FORMS)
def test_simulate_mixture_read_data_equals_jax(genomes, snps, tmp_path,
                                               form):
    """Two genomes at different depths, base-call errors on: the port's
    seqdata is the JAX package's row for row."""
    ref = str(tmp_path / 'jax.h5')
    np.random.seed(5)
    jax_seqread.simulate_mixture_read_data(
        ref, genomes[0], [0.02, 0.01], snps[0], PARAMS)
    got = store_path(tmp_path, 'torch', form)
    torch_seqread.simulate_mixture_read_data(
        got, genomes[1], [0.02, 0.01], snps[1], PARAMS,
        rng=np.random.RandomState(5))
    assert_same_seqdata(got, ref)


def test_simulate_in_chunks_equals_the_jax_loop(genomes, snps, tmp_path):
    """More fragments than one chunk: the port's function with
    ``chunk_cap`` lowered against the JAX function's loop, run with the
    same cap through the JAX package's own helpers (its cap is fixed at
    40M)."""
    cap = 12000
    ref = str(tmp_path / 'jax.h5')
    np.random.seed(6)
    writer = jax_seqdataio.Writer(ref)
    ids = jax_seqread._FragmentIds()
    chunks = 0
    for genome, read_depth in zip(genomes[0], [0.02, 0.01]):
        segment_table = jax_seqread._signed_segment_table(genome)
        rearranged_length = segment_table['length'].sum()
        remaining = int(rearranged_length * read_depth)
        while remaining > 0:
            chunks += 1
            starts, lengths = jax_seqread.simulate_fragment_intervals(
                rearranged_length, min(cap, remaining),
                PARAMS['read_length'], PARAMS['fragment_mean'],
                PARAMS['fragment_stddev'])
            fragments = jax_seqread._map_fragments_to_reference(
                segment_table, starts, lengths)
            for chromosome, chrom_fragments in fragments.groupby(
                    segment_table['chromosome']):
                remaining -= jax_seqread._emit_chromosome(
                    writer, ids, chromosome,
                    chrom_fragments[['start', 'end', 'allele']],
                    snps[0], PARAMS)
    writer.close()
    assert chunks > 4

    got = str(tmp_path / 'torch')
    torch_seqread.simulate_mixture_read_data(
        got, genomes[1], [0.02, 0.01], snps[1], PARAMS,
        rng=np.random.RandomState(6), chunk_cap=cap)
    assert_same_seqdata(got, ref)


@pytest.mark.parametrize('form', FORMS)
def test_resample_mixture_read_data_equals_jax(genomes, snps, tmp_path,
                                               form):
    """Real reads resampled to a mixture's depths: the same draws from the
    same source store."""
    source = str(tmp_path / 'source.h5')
    np.random.seed(21)
    jax_seqread.simulate_mixture_read_data(source, genomes[0][:1], [0.05],
                                           snps[0], PARAMS)
    ref = str(tmp_path / 'jax.h5')
    np.random.seed(22)
    jax_seqread.resample_mixture_read_data(
        ref, source, genomes[0], [0.02, 0.015], snps[0], PARAMS)
    got = store_path(tmp_path, 'torch', form)
    torch_seqread.resample_mixture_read_data(
        got, source, genomes[1], [0.02, 0.015], snps[1], PARAMS,
        rng=np.random.RandomState(22))
    assert_same_seqdata(got, ref)


def test_depth_targets_sum_as_pandas_does(genomes):
    """The target depths are pandas' groupby sums bit for bit (Kahan
    compensated), on depths whose naive sum rounds differently."""
    depths = [0.1, 0.2, 0.3]
    jax_targets = jax_seqread._mixture_depth_targets(
        genomes[0] + genomes[0][:1], depths)
    got = torch_seqread._mixture_depth_targets(
        genomes[1] + genomes[1][:1], depths)
    assert got.columns == list(jax_targets.columns)
    assert got['chromosome'].tolist() == list(jax_targets['chromosome'])
    for name in jax_targets.columns[1:]:
        ref = jax_targets[name].values
        assert got[name].dtype == ref.dtype, name
        np.testing.assert_array_equal(got[name], ref, err_msg=name)
    values = np.array([0.1, 0.2, 0.3, 0.1, 0.2, 0.3, 0.7])
    starts = np.array([0, 3])
    ref = pd.Series(values).groupby(np.repeat([0, 1], [3, 4])).sum().values
    np.testing.assert_array_equal(
        torch_seqread.kahan_group_sums(values, starts), ref)


# ---------------------------------------------------------------------------
# germline alleles
# ---------------------------------------------------------------------------

PANEL_CHROMOSOMES = ('1', '2')


@pytest.fixture(scope='module')
def panel(tmp_path_factory):
    """A reference directory holding a small impute2 panel of two
    chromosomes: 400 rows each, indels among them, 16 individuals."""
    cs = chip_smoke()
    ref_dir = str(tmp_path_factory.mktemp('panel'))
    rng = np.random.RandomState(8)
    for chromosome in PANEL_CHROMOSOMES:
        positions = np.sort(rng.choice(np.arange(1, 3000000), 400,
                                       replace=False))
        bases = np.array(list('ACGT'))
        a0 = bases[rng.randint(0, 4, 400)].astype(object)
        a1 = bases[(rng.randint(1, 4, 400)
                    + np.searchsorted(bases, a0)) % 4].astype(object)
        indel = rng.random_sample(400) < 0.1
        a1[indel] = a0[indel] + 'T'
        cs.write_impute_panel(
            os.path.join(ref_dir, 'ALL_1000G_phase1integrated_v3_impute'),
            chromosome, positions, a0, a1, 16, rng)
    return ref_dir


def assert_same_alleles(got, ref):
    assert got.columns == list(ref.columns)
    assert len(got) == len(ref)
    for name in ref.columns:
        if name in ('ref', 'alt', 'nt_0', 'nt_1'):
            assert got[name].tolist() == [str(v) for v in ref[name]], name
        else:
            assert got[name].dtype == ref[name].dtype, name
            np.testing.assert_array_equal(got[name], ref[name].values,
                                          err_msg=name)


@pytest.mark.parametrize('seed', [1, 2])
def test_create_sim_alleles_equals_jax(panel, seed):
    """Two seeds, recombination at 2e-6 a base (several regions a
    chromosome); the indels are dropped."""
    np.random.seed(seed)
    ref = jax_haplotype.create_sim_alleles('1', {}, panel,
                                           recomb_rate=2e-6)
    got = torch_haplotype.create_sim_alleles(
        '1', {}, panel, recomb_rate=2e-6, rng=np.random.RandomState(seed))
    assert 300 < len(got) < 400
    assert len({(a, b) for a, b in zip(got['is_alt_0'], got['is_alt_1'])}) \
        > 1
    assert_same_alleles(got, ref)


@pytest.mark.parametrize('form', FORMS)
def test_germline_store_round_trips_and_equals_jax(panel, tmp_path, form):
    """simulate_germline_alleles of both packages: the port's store reads
    back exactly in either form and equals the JAX store; each package
    reads the other's HDF5 file."""
    params = dict(random_seed=3, chromosomes=list(PANEL_CHROMOSOMES))
    ref = str(tmp_path / 'jax.h5')
    jax_pipeline.simulate_germline_alleles(ref, params, {}, panel)
    got = store_path(tmp_path, 'torch', form)
    torch_pipeline.simulate_germline_alleles(got, params, {}, panel)

    rng = np.random.RandomState(3)
    for chromosome in PANEL_CHROMOSOMES:
        direct = torch_haplotype.create_sim_alleles(chromosome, {}, panel,
                                                    rng=rng)
        loaded = torch_pipeline.load_germline_alleles(got, chromosome)
        assert loaded.columns == direct.columns
        for name in direct.columns:
            assert loaded[name].dtype == direct[name].dtype, name
            assert loaded[name].tolist() == direct[name].tolist(), name
        jax_loaded = jax_pipeline.load_germline_alleles(ref, chromosome)
        assert_same_alleles(
            torch_pipeline.load_germline_alleles(ref, chromosome),
            jax_loaded[list(torch_pipeline.GERMLINE_COLUMNS)])
        if form == 'h5':
            other = jax_pipeline.load_germline_alleles(got, chromosome)
            pd.testing.assert_frame_equal(other, jax_loaded)


def test_hap_columns_read_in_either_line_form(tmp_path):
    """Blocks of single-character fields are sliced as bytes; a block with
    another spacing, or a last line without its newline, is split."""
    import gzip
    rows = np.random.RandomState(2).randint(0, 2, (50, 8))
    text = ''.join(' '.join(map(str, r)) + '\n' for r in rows)
    columns = [1, 2, 7]
    for name, body in (('plain', text), ('no_newline', text.rstrip('\n')),
                       ('spaced', text.replace(' ', '  ', 3))):
        path = str(tmp_path / (name + '.hap.gz'))
        with gzip.open(path, 'wt') as f:
            f.write(body)
        got = torch_haplotype.read_hap_columns(path, columns)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, rows[:, columns], err_msg=name)


def test_resample_writes_a_chromosome_the_source_lacks(genomes, snps,
                                                       tmp_path):
    """A chromosome with no source fragments is written empty; the JAX
    function's interval overlap fails on it."""
    full = str(tmp_path / 'full')
    torch_seqread.simulate_mixture_read_data(
        full, genomes[1][:1], [0.05], snps[1], PARAMS,
        rng=np.random.RandomState(21))
    kept = sorted(torch_seqdataio.read_chromosomes(full))[0]
    source = str(tmp_path / 'source')
    writer = torch_seqdataio.Writer(source)
    writer.write(kept, torch_seqdataio.read_fragment_data(
        full, kept, keep_cols=True), torch_seqdataio.read_allele_data(
            full, kept))
    writer.close()
    out = str(tmp_path / 'resampled')
    torch_seqread.resample_mixture_read_data(
        out, source, genomes[1], [0.02, 0.015], snps[1], PARAMS,
        rng=np.random.RandomState(22))
    chromosomes = torch_seqdataio.read_chromosomes(out)
    assert len(chromosomes) == 2 and kept in chromosomes
    for chromosome in chromosomes:
        rows = len(torch_seqdataio.read_fragment_data(out, chromosome))
        assert (rows > 0) == (chromosome == kept), chromosome
