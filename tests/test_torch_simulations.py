"""The port's genome simulation (``remixt_tpu_torch.simulations``) against
the JAX package's: the same seed gives the same genomes, collection,
mixture and experiment bit for bit (every array, every seed, the detected
breakpoints in their order), the same minimized breakpoint copy number and
matched pairs, the same simulation definitions, and byte-identical tables;
and a fit seeded from the simulated truth (``optimal_initialization``)
equals the JAX fit at the fits' bars (h rtol 1e-7, ELBO rtol 1e-8, copy
number exact), at the sizes of ``tests/test_simulations.py``'s fixture
(N=100, a swarm of 20).
"""

import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import remixt_tpu.simulations.balanced as jax_balanced
import remixt_tpu.simulations.genome as jax_genome
import remixt_tpu.simulations.pipeline as jax_pipeline
from remixt_tpu.analysis import pipeline as jax_fit_pipeline
from remixt_tpu_torch.analysis import pipeline as torch_fit_pipeline
from remixt_tpu_torch.simulations import balanced as torch_balanced
from remixt_tpu_torch.simulations import genome as torch_genome
from remixt_tpu_torch.simulations import pipeline as torch_pipeline

from test_simulations import GENOME_PARAMS

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [11, 12, 13]
# test_simulations.py's sampled_experiment fixture, seeded per case
PARAMS = dict(
    GENOME_PARAMS,
    N=100, M=3,
    num_ancestral_events=10, num_descendent_events=4,
    ploidy=2.0, ploidy_max_error=0.7,
    proportion_loh=0.1, proportion_loh_max_error=0.3,
    proportion_subclonal=0.1, proportion_subclonal_max_error=0.3,
    proportion_subclonal_stddev=0.1,
    ploidy_stddev=0.3, proportion_loh_stddev=0.1,
    num_swarm=20,
    frac_normal=0.4, num_false_breakpoints=5,
    h_total=0.08,
)


def _load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


@pytest.fixture(scope='module')
def simulated(tmp_path_factory):
    """{seed: (JAX experiment, port experiment, directory)}, each from its
    package's ``simulate_experiment`` task, made once per seed."""
    cache = {}

    def get(seed):
        if seed not in cache:
            tmp = tmp_path_factory.mktemp('sim_{}'.format(seed))
            params = dict(PARAMS, random_seed=seed)
            jax_pipeline.simulate_experiment(str(tmp / 'jax.pickle'), None,
                                             params)
            torch_pipeline.simulate_experiment(str(tmp / 'torch.pickle'),
                                               None, params)
            cache[seed] = (_load(tmp / 'jax.pickle'),
                           _load(tmp / 'torch.pickle'), tmp)
        return cache[seed]
    return get


def assert_same_array(got, ref, msg):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype, msg
    np.testing.assert_array_equal(got, ref, err_msg=msg)


def assert_same_genome(got, ref, msg):
    assert got.N == ref.N, msg
    assert got.init_seed == ref.init_seed, msg
    assert got.event_seeds == ref.event_seeds, msg
    assert got.event_params == ref.event_params, msg
    assert len(got._chromosomes) == len(ref._chromosomes), msg
    for a, b in zip(got._chromosomes, ref._chromosomes):
        assert_same_array(a, b, msg + ' chromosome')
    for field in ('l', 'segment_chromosome_id', 'segment_start',
                  'segment_end', '_wt_keys'):
        assert_same_array(getattr(got, field), getattr(ref, field),
                          msg + ' ' + field)


def assert_same_frame(table, frame, msg=''):
    """A port Table against a pandas DataFrame: columns in order, dtypes
    (strings as objects), values and index."""
    assert table.columns == [str(c) for c in frame.columns], msg
    np.testing.assert_array_equal(table.index, frame.index.values,
                                  err_msg=msg)
    for name in frame.columns:
        values = frame[name].values
        if values.dtype.kind not in 'biuf':
            values = np.asarray(values, dtype=object)
        assert table[name].dtype == values.dtype, (msg, name)
        np.testing.assert_array_equal(table[name], values,
                                      err_msg='{} {}'.format(msg, name))


@pytest.mark.parametrize('seed', SEEDS)
def test_simulate_experiment_matches_jax(simulated, seed):
    ref, got, _ = simulated(seed)
    for field in ('x', 'h', 'phi', 'h_pred', 'is_outlier_total',
                  'is_outlier_allele', 'segment_major_is_allele_a', 'N', 'M',
                  'l', 'cn', 'segment_chromosome_id', 'segment_start',
                  'segment_end'):
        assert_same_array(getattr(got, field), getattr(ref, field), field)
    assert list(got.breakpoints.items()) == list(ref.breakpoints.items())
    assert got.adjacencies == ref.adjacencies
    assert list(got.chains) == list(ref.chains)

    mixture, ref_mixture = got.genome_mixture, ref.genome_mixture
    assert_same_array(mixture.frac, ref_mixture.frac, 'frac')
    assert (list(mixture.detected_breakpoints.items())
            == list(ref_mixture.detected_breakpoints.items()))
    assert_same_frame(mixture.breakpoint_segment_data,
                      ref_mixture.breakpoint_segment_data)

    collection = mixture.genome_collection
    ref_collection = ref_mixture.genome_collection
    assert_same_array(collection.cn, ref_collection.cn, 'cn')
    assert list(collection.adjacencies) == list(ref_collection.adjacencies)
    assert list(collection.breakpoints) == list(ref_collection.breakpoints)
    assert (list(collection.breakpoint_copy_number)
            == list(ref_collection.breakpoint_copy_number))
    for bp, cn in ref_collection.breakpoint_copy_number.items():
        assert_same_array(collection.breakpoint_copy_number[bp], cn, str(bp))
    assert (collection.balanced_breakpoints
            == ref_collection.balanced_breakpoints)
    assert len(collection.genomes) == len(ref_collection.genomes)
    for m, (a, b) in enumerate(zip(collection.genomes,
                                   ref_collection.genomes)):
        assert_same_genome(a, b, 'genome {}'.format(m))


@pytest.mark.parametrize('seed', SEEDS)
def test_minimize_breakpoint_copies_matches_jax(simulated, seed):
    """On each sampled collection: the same matched pairs for every
    clone's breakpoints, the same minimized copy numbers (and no larger
    than the raw ones, as ``test_simulations.py`` checks), in order."""
    ref, got, _ = simulated(seed)
    collection = got.genome_mixture.genome_collection
    ref_collection = ref.genome_mixture.genome_collection
    reference_edges = jax_balanced._allele_adjacency_edges(
        ref_collection.adjacencies)
    for m in range(ref_collection.M):
        variant_edges = [tuple(bp) for bp, cn
                         in ref_collection.breakpoint_copy_number.items()
                         if cn[m] > 0 and len(bp) == 2]
        assert (torch_balanced._matched_layer_pairs(variant_edges,
                                                    reference_edges)
                == jax_balanced._matched_layer_pairs(variant_edges,
                                                     reference_edges))

    minimal = torch_balanced.minimize_breakpoint_copies(
        ref_collection.adjacencies, ref_collection.breakpoint_copy_number)
    ref_minimal = jax_balanced.minimize_breakpoint_copies(
        ref_collection.adjacencies, ref_collection.breakpoint_copy_number)
    assert list(minimal) == list(ref_minimal)
    for bp, cn in ref_minimal.items():
        assert_same_array(minimal[bp], cn, str(bp))

    collapsed = collection.collapsed_minimal_breakpoint_copy_number()
    ref_collapsed = ref_collection.collapsed_minimal_breakpoint_copy_number()
    full = collection.collapsed_breakpoint_copy_number()
    assert list(collapsed) == list(ref_collapsed)
    assert set(collapsed) == set(full)
    for bp, cn in ref_collapsed.items():
        assert_same_array(collapsed[bp], cn, str(bp))
        assert np.all(collapsed[bp] <= full[bp])


def test_minimize_breakpoint_copies_cancels_a_balanced_cycle():
    """A reciprocal translocation between segments 0|1 and 2|3 cancels in
    clone 1, where both its breakpoints are present: they and the two
    wild-type adjacencies they break form a balanced cycle. In clone 2 one
    breakpoint alone is no cycle and stays."""
    adjacencies = {(0, 1), (2, 3)}
    brk_cn = {
        frozenset([((0, 0), 1), ((3, 0), 0)]): np.array([0., 1., 1.]),
        frozenset([((2, 0), 1), ((1, 0), 0)]): np.array([0., 1., 0.]),
    }
    got = torch_balanced.minimize_breakpoint_copies(adjacencies, brk_cn)
    ref = jax_balanced.minimize_breakpoint_copies(adjacencies, brk_cn)
    assert list(got) == list(ref)
    for bp in ref:
        assert_same_array(got[bp], ref[bp], str(bp))
    assert [cn.tolist() for cn in got.values()] == [[0., 0., 1.],
                                                    [0., 0., 0.]]
    assert torch_balanced.minimize_breakpoint_copies(adjacencies, {}) == {}


def test_create_simulations_matches_jax():
    path = os.path.join(REPO, 'benchmark', 'accuracy_sim_defs.yaml')
    got = torch_pipeline.create_simulations(path, {}, None)
    ref = jax_pipeline.create_simulations(path, {}, None)
    assert list(got.items()) == list(ref.items())
    assert list(got) == [
        '{}_0_{}'.format(name, rep)
        for name in ('accuracy', 'low_tumour', 'noisy_breakpoints')
        for rep in range(3)]


def test_create_simulations_needs_chromosome_lengths(tmp_path):
    path = tmp_path / 'defs.yaml'
    path.write_text('defaults: {N: 10}\nsimulations:\n  a: '
                    '{num_simulations: 1, num_replicates: 1, '
                    'random_seed_start: 1}\n')
    with pytest.raises(ValueError, match='chromosome_lengths'):
        torch_pipeline.create_simulations(str(path), {}, None)
    # with reference data the lengths come from its FASTA index (chromosomes
    # 1 to 22 by default), as in the JAX package
    (tmp_path / 'Homo_sapiens.GRCh38.93.dna.chromosomes.fa.fai').write_text(
        ''.join('{}\t{}\t0\t60\t61\n'.format(c, 1000000 + k)
                for k, c in enumerate([str(c) for c in range(1, 23)] + ['X'])))
    got = torch_pipeline.create_simulations(str(path), {}, str(tmp_path))
    assert got == jax_pipeline.create_simulations(str(path), {},
                                                  str(tmp_path))
    assert list(got['a_0_0']['chromosome_lengths']) == [
        str(c) for c in range(1, 23)]


def test_read_sim_defs_matches_jax(tmp_path):
    defs = tmp_path / 'defs.py'
    defs.write_text(
        "defaults = {'a': 1, 'N': 100}\n"
        "base_settings = {'b': [1, 2], ('c', 'd'): [(1, 2), (3, 4)]}\n"
        "other_settings = {'N': [50]}\n")
    got = torch_pipeline.read_sim_defs(str(defs))
    assert list(got.items()) == list(
        jax_pipeline.read_sim_defs(str(defs)).items())
    assert len(got) == 5


def _genome_params(**overrides):
    return dict(GENOME_PARAMS, **overrides)


def _port_genome(seed, num_events, N=100, params=None):
    params = _genome_params() if params is None else params
    rng = np.random.RandomState(seed)
    genome = torch_genome.RearrangedGenome(N)
    genome.create(dict(params), rng)
    for _ in range(num_events):
        genome.rearrange(dict(params), rng)
    return genome


def _jax_genome(seed, num_events, N=100, params=None):
    params = _genome_params() if params is None else params
    np.random.seed(seed)
    genome = jax_genome.RearrangedGenome(N)
    genome.create(dict(params))
    for _ in range(num_events):
        genome.rearrange(dict(params))
    return genome


@pytest.mark.parametrize('seed', [123, 7])
def test_genome_history_replays_and_matches_jax(seed):
    """An explicit generator reseeded in place draws the JAX package's
    genome; replaying the recorded seeds rebuilds it, and a rewind equals
    a replay of the first events."""
    genome = _port_genome(seed, 12)
    assert_same_genome(genome, _jax_genome(seed, 12), 'genome')
    assert genome.chromosomes == _jax_genome(seed, 12).chromosomes

    before = genome.chromosomes
    genome.recreate()
    assert genome.chromosomes == before

    partial = genome.copy()
    partial.rewind(4)
    replay = torch_genome.RearrangedGenome(genome.N)
    replay.init_params = genome.init_params
    replay.init_seed = genome.init_seed
    replay.event_params = list(genome.event_params[:4])
    replay.event_seeds = list(genome.event_seeds[:4])
    replay.recreate()
    assert partial.chromosomes == replay.chromosomes
    assert len(genome.event_seeds) == 12


def test_genome_statistics_and_tables_match_jax():
    genome, ref = _port_genome(5, 15), _jax_genome(5, 15)
    for name in ('length_loh', 'length_hdel', 'length_hlamp', 'ploidy',
                 'proportion_loh', 'proportion_hdel', 'proportion_hlamp',
                 'proportion_minor_state', 'proportion_major_state'):
        assert_same_array(getattr(genome, name)(), getattr(ref, name)(),
                          name)
    other, ref_other = _port_genome(6, 3), _jax_genome(6, 3)
    assert genome.length_divergent(other) == ref.length_divergent(ref_other)
    assert genome.breakpoint_copy_number == ref.breakpoint_copy_number
    assert genome.wt_adj == ref.wt_adj
    assert_same_frame(genome.segment_copy_table(), ref.segment_copy_table())


def test_chromosome_sequences_match_jax():
    params = _genome_params(chromosome_lengths={'1': 3000, '2': 2000},
                            seg_length_min=10)
    genome, ref = (_port_genome(3, 6, N=12, params=params),
                   _jax_genome(3, 6, N=12, params=params))
    rng = np.random.RandomState(0)
    germline = {(c, allele): ''.join(rng.choice(list('ACGT'), size=n))
                for c, n in (('1', 3000), ('2', 2000)) for allele in (0, 1)}
    sequences = genome.create_chromosome_sequences(germline)
    assert sequences == ref.create_chromosome_sequences(germline)
    assert sum(map(len, sequences)) > 0


def test_breakpoint_table_foldback_single_breakend():
    """A fold-back junction (one breakend) fills the _2 columns, as the
    JAX package's table does."""
    genome = _port_genome(31, 0)
    collection = torch_genome.GenomeCollection([genome])
    ref_collection = jax_genome.GenomeCollection([_jax_genome(31, 0)])
    table = torch_genome._breakpoint_table({7: frozenset([(3, 1)])},
                                           collection)
    assert_same_frame(table, jax_genome._breakpoint_table(
        {7: frozenset([(3, 1)])}, ref_collection))
    assert table['n_2'][0] == 3 and table['position_2'][0] == \
        table['position_1'][0]


def test_sample_random_breakpoints_matches_jax():
    adjacencies = {(n, n + 1) for n in range(29)}
    got = torch_genome.sample_random_breakpoints(
        30, 40, adjacencies, np.random.RandomState(4),
        excluded_breakpoints={frozenset([(1, 1), (2, 0)])})
    np.random.seed(4)
    ref = jax_genome.sample_random_breakpoints(
        30, 40, adjacencies,
        excluded_breakpoints={frozenset([(1, 1), (2, 0)])})
    assert list(got) == list(ref) and len(got) == 40


@pytest.mark.parametrize('emission_model,extra', [
    ('poisson', {}), ('negbin', {}),
    ('negbin_betabin', {'frac_beta_noise_stddev': 0.05})])
def test_experiment_sampler_options_match_jax(simulated, emission_model,
                                              extra):
    """The other emission models and the perturbed fractions draw what the
    JAX sampler draws from the same stream."""
    ref, _, _ = simulated(SEEDS[0])
    params = dict(PARAMS, emission_model=emission_model, **extra)
    got = torch_genome.ExperimentSampler(params).sample_experiment(
        ref.genome_mixture, np.random.RandomState(21))
    np.random.seed(21)
    want = jax_genome.ExperimentSampler(params).sample_experiment(
        ref.genome_mixture)
    for field in ('x', 'phi', 'h_pred', 'segment_major_is_allele_a'):
        assert_same_array(getattr(got, field), getattr(want, field), field)


@pytest.mark.parametrize('frac_clone_1,M', [(None, 3), (0.3, 4)])
def test_mixture_fractions_match_jax(frac_clone_1, M):
    params = dict(PARAMS, frac_clone_1=frac_clone_1)
    got = torch_genome.GenomeMixtureSampler(params)._sample_fractions(
        M, np.random.RandomState(8))
    np.random.seed(8)
    ref = jax_genome.GenomeMixtureSampler(params)._sample_fractions(M)
    assert_same_array(got, ref, 'frac')


def test_tables_match_jax(simulated, tmp_path):
    """The summary, segment, perfect-segment and breakpoint TSVs and the
    merged table are byte-identical to the JAX package's, from each
    package's pickles."""
    _, _, sim_dir = simulated(SEEDS[0])
    params = dict(PARAMS, random_seed=SEEDS[0])
    outputs = {}
    for name, module in (('jax', jax_pipeline), ('torch', torch_pipeline)):
        out = tmp_path / name
        out.mkdir()
        mixture = str(out / 'mixture.pickle')
        module.simulate_genome_mixture(mixture, None, params)
        experiment = str(sim_dir / '{}.pickle'.format(name))
        tables = {}
        for seed_label in ('a', 'b'):
            tables[seed_label] = str(out / 'exp_{}.tsv'.format(seed_label))
            module.tabulate_experiment(tables[seed_label],
                                       'sim_' + seed_label, experiment)
        module.merge_tables(str(out / 'merged.tsv'), tables)
        module.write_segments(str(out / 'segments.tsv'), mixture)
        module.write_perfect_segments(str(out / 'perfect.tsv'), mixture)
        module.write_breakpoints(str(out / 'breakpoints.tsv'), mixture)
        outputs[name] = out
    for filename in ('exp_a.tsv', 'merged.tsv', 'segments.tsv',
                     'perfect.tsv', 'breakpoints.tsv'):
        got = (outputs['torch'] / filename).read_bytes()
        assert got == (outputs['jax'] / filename).read_bytes(), filename
        assert got.count(b'\n') > 1, filename
    pd.testing.assert_frame_equal(
        pd.read_csv(outputs['torch'] / 'perfect.tsv', sep='\t'),
        pd.read_csv(outputs['jax'] / 'perfect.tsv', sep='\t'))


def test_plot_files_are_refused(tmp_path):
    params = dict(PARAMS, random_seed=SEEDS[0])
    with pytest.raises(NotImplementedError, match='plots'):
        torch_pipeline.simulate_experiment(str(tmp_path / 'e.pickle'),
                                           str(tmp_path / 'e.pdf'), params)
    with pytest.raises(NotImplementedError, match='plots'):
        torch_pipeline.simulate_genome_mixture(str(tmp_path / 'm.pickle'),
                                               str(tmp_path / 'm.pdf'),
                                               params)
    assert not os.listdir(tmp_path)


def test_optimal_initialization_fit_matches_jax(simulated):
    """One restart at the simulated h, its breakpoints seeded from the
    truth, through ``pipeline.fit``, float64 on the CPU, against the JAX
    fit of the JAX package's experiment."""
    ref, got, _ = simulated(SEEDS[0])
    config = {'max_copy_number': 6, 'num_em_iter': 1, 'num_update_iter': 2,
              'engine_dtype': 'float64', 'optimal_initialization': True}
    h = ref.h
    init_params = dict(mode_idx=0, h_normal=h[0], h_tumour=h[1] + h[2],
                       mix_frac=h[1] / (h[1] + h[2]), divergence_weight=1e-7,
                       max_depth=float((ref.x[:, 2] / ref.l).max() * 1.5))
    port = torch_fit_pipeline.fit(got, init_params, config, device='cpu')
    jax = jax_fit_pipeline.fit(ref, init_params, config)
    np.testing.assert_allclose(port['h'], jax['h'], rtol=1e-7)
    np.testing.assert_allclose(port['stats']['elbo'], jax['stats']['elbo'],
                               rtol=1e-8)
    np.testing.assert_array_equal(port['cn'], jax['cn'])
    assert list(port['brk_cn']) == list(jax['brk_cn'])
    for bp_id, cn in jax['brk_cn'].items():
        np.testing.assert_array_equal(port['brk_cn'][bp_id], cn)
    assert np.isfinite(port['stats']['elbo'])
