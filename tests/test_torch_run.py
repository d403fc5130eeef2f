"""The ``run`` path of the port (``remixt_tpu_torch.workflow.
create_remixt_bam_workflow``) against the JAX package's on the same
synthetic BAMs and reference, on the CPU.

The inputs are ``chip_smoke.make_run_fixture``'s at a small size (two
chromosomes of 3 and 2 Mb, segments of 100 kb, the tumour at 2× and the
normal at 4×, 10 phasing draws, 10^5 GC samples), made from seeds; the
phasing tools are ``chip_smoke.write_standin_tools``' stand-ins, first on
the PATH. Both workflows run from the same numpy global seed. The JAX
workflow runs up to its experiment (its fit and ploidy plots are left
out); the port's runs to its results store, the fit at 1 EM × 1 VI on the
CPU. Segments, haplotypes, the count tables and the experiment must be
equal: integers exactly, floats at rtol 1e-12.

Run as a script, ``python tests/test_torch_run.py --phase11 WORKDIR``
makes ``chip_smoke.py`` phase 11's inputs (the three chromosomes of
``RUN_CHROMOSOMES`` at their full length), runs the JAX package's whole
``create_remixt_bam_workflow`` on them (its fit at the defaults, on the
CPU) and the port's up to the count table, checks that the two count
tables are equal, and prints the digests of the count table, the restart
the JAX fit chose (by the JAX package's own selection, ``jax_fit_choice``),
every restart's ELBO and proportion divergent, the JAX package's
evaluation of the chosen solution against the truth, and the JAX
package's refits of the restarts near the chosen one, in float64 and in
float32 from inputs moved by one float32 ulp (``jax_near_references``):
the constants ``RUN_JAX`` of ``chip_smoke.py``. With ``--near`` it makes
only the refits, from a WORKDIR where such a run has finished.
"""

import importlib.util
import json
import os
import pickle
import shutil
import sys
import time

import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHROMOSOMES = {'1': 3000000, '2': 2000000}
DEPTHS = {'tumour': 2.0, 'normal': 4.0}
MIXTURE = dict(N=40, num_ancestral_events=10, num_descendent_events=5,
               num_false_breakpoints=3)
CONFIG = dict(segment_length=100000, shapeit_num_samples=10,
              sample_gc_num_positions=100000, num_em_iter=1,
              num_update_iter=1, tumour_mix_fractions=[0.45, 0.3],
              divergence_weights=[1e-7], max_copy_number=6)
# the intermediate tables both workflows write, under the raw directory
TABLES = ['segments.tsv', 'haplotypes.tsv',
          'tmp/counts/segment_counts/tumour.tsv',
          'tmp/counts/allele_counts/tumour.tsv',
          'tmp/counts/phased_allele_counts/tumour.tsv',
          'tmp/rawcounts/tumour.tsv', 'tmp/bias/tumour/biases.tsv',
          'counts/sample_tumour.tsv']


def without_fit(workflow):
    """The JAX workflow's tasks up to the experiment."""
    workflow.tasks = [t for t in workflow.tasks
                      if '/fit_model_' not in t.name
                      and 'ploidy' not in t.name]
    return workflow


def run_workflow(module, fixture, raw, config, results, **kwargs):
    workflow = module.create_remixt_bam_workflow(
        fixture['breakpoint_file'], fixture['bams'], {'tumour': results},
        raw, config, fixture['ref_data_dir'], normal_id='normal', **kwargs)
    return workflow


def jax_config(fixture, overrides):
    """The JAX package reads the mappability store in its HDF5 form."""
    return dict(fixture['config'], **overrides, mappability_filename=(
        fixture['config']['mappability_filename'] + '.h5'))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import remixt_tpu.workflow as jax_workflow
    import remixt_tpu_torch.workflow as torch_workflow

    cs = chip_smoke()
    root = tmp_path_factory.mktemp('torch_run')
    fixture = cs.make_run_fixture(str(root / 'fixture'), CHROMOSOMES,
                                  depths=DEPTHS, with_hdf5=True,
                                  mixture_params=MIXTURE)
    bin_dir = cs.write_standin_tools(str(root / 'bin'))
    path = os.environ['PATH']
    os.environ['PATH'] = bin_dir + os.pathsep + path
    try:
        raw = {'jax': str(root / 'jax'), 'torch': str(root / 'torch')}
        np.random.seed(cs.RUN_NUMPY_SEED)
        without_fit(run_workflow(
            jax_workflow, fixture, raw['jax'], jax_config(fixture, CONFIG),
            os.path.join(raw['jax'], 'results.h5'))).run(raw['jax'])
        config = dict(fixture['config'], **CONFIG, **pinned_depths(
            os.path.join(raw['jax'], 'counts', 'sample_tumour.tsv'),
            fixture['breakpoint_file'], root))
        np.random.seed(cs.RUN_NUMPY_SEED)
        results = os.path.join(raw['torch'], 'results.h5')
        run_workflow(torch_workflow, fixture, raw['torch'], config, results,
                     device='cpu').run(raw['torch'])
    finally:
        os.environ['PATH'] = path
    return dict(fixture=fixture, raw=raw, results=results, root=root,
                bin_dir=bin_dir, config=config)


def pinned_depths(count_file, breakpoint_file, root):
    """h_normal and h_tumour of the first mode of the grid that init
    makes of the count table: pinned, they leave one mode, so the grid is
    the two mix fractions."""
    from remixt_tpu_torch.analysis import experiment, pipeline
    path = str(root / 'pinned.pickle')
    experiment.create_experiment(count_file, breakpoint_file, path)
    with open(path, 'rb') as f:
        grid = pipeline.enumerate_restarts(pickle.load(f), CONFIG)[0]
    return dict(h_normal=float(grid['h_normal'][0]),
                h_tumour=float(grid['h_tumour'][0]))


def read(raw, name):
    return pd.read_csv(os.path.join(raw, name), sep='\t',
                       converters={'chromosome': str})


def assert_frame_equal(got, ref, label):
    assert list(got.columns) == list(ref.columns), label
    assert got.shape == ref.shape, label
    for name in ref.columns:
        if ref[name].dtype.kind == 'f':
            np.testing.assert_allclose(got[name].values, ref[name].values,
                                       rtol=1e-12, atol=0,
                                       err_msg='{} {}'.format(label, name))
        else:
            assert [str(v) for v in got[name]] == \
                [str(v) for v in ref[name]], (label, name)


@pytest.mark.parametrize('name', TABLES)
def test_tables_match_jax(runs, name):
    ref = read(runs['raw']['jax'], name)
    assert len(ref) > 0, name
    assert_frame_equal(read(runs['raw']['torch'], name), ref, name)


def test_phasing_has_blocks_and_counts_cover_alleles(runs):
    """The stand-in phasing makes more than one block a chromosome, and
    the count table has reads and allele reads (segments in unmappable
    stretches have none)."""
    haps = read(runs['raw']['torch'], 'haplotypes.tsv')
    for chromosome in CHROMOSOMES:
        assert haps[haps['chromosome'] == chromosome]['hap_label'] \
            .nunique() > 1, chromosome
    counts = read(runs['raw']['torch'], 'counts/sample_tumour.tsv')
    assert counts['major_readcount'].sum() > 0
    assert (counts['readcount'] > 0).mean() > 0.9


def test_experiment_matches_jax(runs):
    def load(raw):
        with open(os.path.join(raw, 'experiment', 'sample_tumour.pickle'),
                  'rb') as f:
            return pickle.load(f)
    assert_experiments_equal(load(runs['raw']['torch']),
                             load(runs['raw']['jax']))


def assert_experiments_equal(got, ref):
    """The port's experiment ``got`` against the JAX package's ``ref``:
    arrays at rtol 1e-12 with the same dtypes, the rest exactly."""
    from test_torch_experiment import assert_column_equal, assert_table_equal
    for name in ('x', 'l', 'segment_start', 'segment_end',
                 'segment_major_is_allele_a'):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-12, atol=0, err_msg=name)
        assert getattr(got, name).dtype == getattr(ref, name).dtype, name
    assert_column_equal(got.segment_chromosome_id, ref.segment_chromosome_id,
                        'segment_chromosome_id')
    assert got.adjacencies == ref.adjacencies
    assert got.breakpoints == ref.breakpoints
    assert_table_equal(got.count_table, ref.count_data, 'count_table')


def test_fit_writes_the_results_store(runs):
    """The port's fit ran on the CPU over the grid and wrote the results
    store with the JAX package's keys."""
    from remixt_tpu_torch.io.store import read_store
    tables = read_store(runs['results'])
    init = [k for k in tables if k.startswith('solutions/')]
    restarts = {k.split('/')[1] for k in init}
    assert len(restarts) == 2
    assert {'stats', 'cn', 'mix', 'brk_cn', 'read_depth',
            'minor_modes'} <= set(tables)
    assert np.all(np.isfinite(tables['stats']['elbo']))


def test_seqdata_is_a_store_of_the_installed_form(runs):
    from remixt_tpu_torch import seqdataio
    from remixt_tpu_torch.io.store import store_name
    path = store_name(os.path.join(
        runs['raw']['torch'], 'seqdata', 'sample_tumour'))
    assert path.endswith('.h5') and os.path.isfile(path)
    assert seqdataio.read_chromosomes(path) == set(CHROMOSOMES)


def test_directory_stores_give_the_same_counts(runs, monkeypatch, tmp_path):
    """Where h5py is missing the seqdata stores are directories (the
    mappability store already is one here): the run up to the experiment
    gives the same tables."""
    import remixt_tpu_torch.workflow as torch_workflow
    from remixt_tpu_torch.io import store

    monkeypatch.setattr(store, 'store_name', lambda stem: stem)
    monkeypatch.setenv('PATH', runs['bin_dir'] + os.pathsep
                       + os.environ['PATH'])
    raw = str(tmp_path / 'raw')
    np.random.seed(chip_smoke().RUN_NUMPY_SEED)
    without_fit(run_workflow(torch_workflow, runs['fixture'], raw,
                             runs['config'], str(tmp_path / 'results'),
                             device='cpu')).run(raw)
    assert os.path.isdir(os.path.join(raw, 'seqdata', 'sample_tumour'))
    for name in TABLES:
        assert_frame_equal(read(raw, name), read(runs['raw']['jax'], name),
                           name)


def test_run_without_cuda_raises_at_the_fit(runs, monkeypatch, tmp_path):
    """Without a device the run prepares the counts, then raises when it
    reaches the fit; nothing of the results is written."""
    import remixt_tpu_torch.ui.run

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('PATH', runs['bin_dir'] + os.pathsep
                       + os.environ['PATH'])
    config = tmp_path / 'config.yaml'
    config.write_text(json.dumps(runs['config']))
    fixture = runs['fixture']
    raw = tmp_path / 'raw'
    results = tmp_path / 'results.h5'
    np.random.seed(chip_smoke().RUN_NUMPY_SEED)
    with pytest.raises(RuntimeError, match='CUDA'):
        remixt_tpu_torch.ui.run.run(
            ref_data_dir=fixture['ref_data_dir'], raw_data_dir=str(raw),
            breakpoint_file=fixture['breakpoint_file'],
            tumour_sample_ids=['tumour'],
            tumour_bam_files=[fixture['bams']['tumour']],
            results_files=[str(results)], normal_sample_id='normal',
            normal_bam_file=fixture['bams']['normal'], config=str(config),
            maxjobs=1)
    assert (raw / 'counts' / 'sample_tumour.tsv').exists()
    assert not results.exists()


def test_run_cli_help():
    import subprocess
    out = subprocess.run(
        [sys.executable, '-m', 'remixt_tpu_torch.ui.main', 'run', '--help'],
        capture_output=True, text=True, check=True, cwd=REPO).stdout
    assert '--tumour_bam_files' in out and '--normal_bam_file' in out


# ---------------------------------------------------------------------------
# phase 11's reference numbers
# ---------------------------------------------------------------------------

def jax_fit_choice(results):
    """The JAX package's own choice on its results store ``results``: the
    restart its ``store_optimal_solution`` aliases at the top of the store,
    checked against the store's top-level ``/mix``, and each restart's ELBO
    and proportion divergent, {init_id: value}."""
    from remixt_tpu.analysis.pipeline import store_optimal_solution
    from remixt_tpu.io.hdf5 import HDFStore

    class Reads(dict):
        def __missing__(self, key):
            self.setdefault('read', []).append(key)

    with HDFStore(results, 'r') as store:
        stats = store['/stats'].sort_values('init_id')
        reads = Reads()
        store_optimal_solution(store['/stats'], reads, {})
        chosen = {int(key.split('/')[2][len('solution_'):])
                  for key in reads['read']}
        assert len(chosen) == 1, reads['read']
        chosen = chosen.pop()
        np.testing.assert_array_equal(
            store['/mix'].values,
            store['/solutions/solution_{}/mix'.format(chosen)].values)
    ids = [int(i) for i in stats['init_id']]
    return dict(restarts=len(stats), chosen=chosen, **{
        name: dict(zip(ids, (float(v) for v in stats[name])))
        for name in ('elbo', 'proportion_divergent')})


def jax_evaluation(mixture, results):
    """The JAX package's evaluation against the truth ``mixture`` of the
    solution at the top of its results store ``results``, flat."""
    import remixt_tpu.simulations.pipeline as jax_sim
    from remixt_tpu.io.hdf5 import HDFStore
    with HDFStore(results, 'r') as store:
        evaluation = jax_sim.evaluate_results(
            mixture, store['/cn'], store['/brk_cn'], store['/mix'].values)
    metrics = {}
    for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results'):
        metrics.update({k: float(v) for k, v in evaluation[name].items()})
    return metrics


#: the restarts whose float32 ELBO in the JAX fit lies within this of the
#: chosen restart's are refitted (one restart's float32 ELBO spans 6.7
#: across the two packages' fits on the CPU and the card: phase 11's
#: restart 10)
NEAR_MARGIN = 10.0
#: the JAX package's float32 refits of those restarts with the segment
#: lengths moved by one float32 ulp, one per seed 1..PERTURBED_FITS
PERTURBED_FITS = 8


def near_restarts(float32):
    """The restarts of a ``jax_fit_choice`` within ``NEAR_MARGIN`` of the
    chosen one's ELBO."""
    floor = float32['elbo'][float32['chosen']] - NEAR_MARGIN
    return sorted(i for i, elbo in float32['elbo'].items() if elbo >= floor)


def jax_refit(experiment, grid, ids, config, mixture, workdir):
    """The JAX package's fit of restarts ``ids`` of ``grid`` on
    ``experiment`` at ``config``, collated by the JAX package into a store
    in ``workdir``: the restart it chooses among them, their ELBOs and
    proportions divergent, and the evaluation against the truth
    ``mixture`` of the chosen solution."""
    import remixt_tpu.analysis.pipeline as jax_pipeline

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    experiment_file = os.path.join(workdir, 'experiment.pickle')
    with open(experiment_file, 'wb') as f:
        pickle.dump(experiment, f)
    init_file = os.path.join(workdir, 'init.h5')
    jax_pipeline.init(init_file, experiment_file, {})
    t0 = time.time()
    fits = jax_pipeline.fit_many(experiment, {i: grid[i] for i in ids},
                                 config)
    print('jax fit of restarts {} at {} in {}'.format(ids, config, workdir),
          round(time.time() - t0, 1), flush=True)
    fit_files = {}
    for init_id, fit in fits.items():
        fit_files[init_id] = os.path.join(workdir,
                                          'fit_{}.pickle'.format(init_id))
        with open(fit_files[init_id], 'wb') as f:
            pickle.dump(fit, f)
    collated = os.path.join(workdir, 'results.h5')
    jax_pipeline.collate(collated, experiment_file, init_file, fit_files, {})
    choice = jax_fit_choice(collated)
    del choice['restarts']
    return dict(choice, evaluation=jax_evaluation(mixture, collated))


def jax_near_references(experiment_file, results, mixture, workdir):
    """The JAX package's refits of the restarts near its choice on its
    results store ``results`` (``near_restarts``), from the same
    experiment and init: in float64 (``jax_enable_x64`` set, without which
    JAX computes the float64 engine in float32), and in float32 with the
    segment lengths moved by one float32 ulp (relative 2**-23, a sign per
    segment from ``RandomState(seed)``) for each seed 1..PERTURBED_FITS.
    Returns dict(float64=jax_refit's dict, perturbed=dict(chosen={seed:
    restart}, elbo={seed: {restart: ELBO}}, proportion_divergent={seed:
    {restart: value}}, evaluation={seed: the metrics of ``ACCURACY_BARS``
    in the evaluation of the solution it chose}))."""
    from remixt_tpu_torch.benchmark.export_evaluation import ACCURACY_BARS
    import jax
    import remixt_tpu.analysis.pipeline as jax_pipeline

    ids = near_restarts(jax_fit_choice(results))
    with open(experiment_file, 'rb') as f:
        experiment = pickle.load(f)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    grid = jax_pipeline.init(os.path.join(workdir, 'init.h5'),
                             experiment_file, {})
    perturbed = {name: {} for name in ('chosen', 'elbo',
                                       'proportion_divergent', 'evaluation')}
    length = experiment.count_data['length'].values.astype(np.float64)
    for seed in range(1, PERTURBED_FITS + 1):
        sign = np.random.RandomState(seed).choice([-1.0, 1.0],
                                                  size=len(length))
        experiment.count_data['length'] = length * (1.0 + sign * 2.0 ** -23)
        refit = jax_refit(experiment, grid, ids, {}, mixture, os.path.join(
            workdir, 'perturbed_{}'.format(seed)))
        for name in ('chosen', 'elbo', 'proportion_divergent'):
            perturbed[name][seed] = refit[name]
        perturbed['evaluation'][seed] = {
            name: value for name, value in refit['evaluation'].items()
            if name in ACCURACY_BARS}
    experiment.count_data['length'] = length
    jax.config.update('jax_enable_x64', True)
    float64 = jax_refit(experiment, grid, ids, {'engine_dtype': 'float64'},
                        mixture, os.path.join(workdir, 'float64'))
    jax.config.update('jax_enable_x64', False)
    return dict(float64=float64, perturbed=perturbed)


def phase11_near(workdir):
    """``jax_near_references`` on a finished ``--phase11`` WORKDIR."""
    with open(os.path.join(workdir, 'jax_mixture.pickle'), 'rb') as f:
        mixture = pickle.load(f)
    raw = os.path.join(workdir, 'jax')
    return jax_near_references(
        os.path.join(raw, 'experiment', 'sample_tumour.pickle'),
        os.path.join(raw, 'results.h5'), mixture,
        os.path.join(workdir, 'near'))


def phase11_reference(workdir):
    """Run the JAX package's whole run path on phase 11's inputs and the
    port's up to the count table; print the constants of ``RUN_JAX``."""
    import remixt_tpu.workflow as jax_workflow
    import remixt_tpu.simulations.pipeline as jax_sim
    import remixt_tpu_torch.workflow as torch_workflow

    cs = chip_smoke()
    fixture_dir = os.path.join(workdir, 'fixture')
    t0 = time.time()
    fixture = cs.make_run_fixture(fixture_dir, cs.RUN_CHROMOSOMES,
                                  with_hdf5=True)
    print('fixture', fixture['pairs'], fixture['times'],
          round(time.time() - t0, 1), flush=True)
    os.environ['PATH'] = cs.write_standin_tools(
        os.path.join(workdir, 'bin')) + os.pathsep + os.environ['PATH']

    raw = {'jax': os.path.join(workdir, 'jax'),
           'torch': os.path.join(workdir, 'torch')}
    for path in raw.values():
        shutil.rmtree(path, ignore_errors=True)
    results = os.path.join(raw['jax'], 'results.h5')
    np.random.seed(cs.RUN_NUMPY_SEED)
    t0 = time.time()
    run_workflow(jax_workflow, fixture, raw['jax'], jax_config(fixture, {}),
                 results).run(raw['jax'])
    print('jax run', round(time.time() - t0, 1), flush=True)

    np.random.seed(cs.RUN_NUMPY_SEED)
    t0 = time.time()
    flow = run_workflow(torch_workflow, fixture, raw['torch'],
                        fixture['config'],
                        os.path.join(raw['torch'], 'results.h5'),
                        device='cpu')
    flow.tasks = [t for t in flow.tasks if '/fit_model_' not in t.name]
    flow.run(raw['torch'])
    print('port run to the counts', round(time.time() - t0, 1), flush=True)
    for name in TABLES:
        assert_frame_equal(read(raw['torch'], name), read(raw['jax'], name),
                           name)
    print('count tables equal', flush=True)

    count_file = os.path.join(raw['jax'], 'counts', 'sample_tumour.tsv')
    digest = cs.count_table_digest(count_file)

    # the JAX package's own simulation of the mixture is the port's
    params = cs.run_mixture_params(cs.RUN_CHROMOSOMES)
    mixture_file = os.path.join(workdir, 'jax_mixture.pickle')
    jax_sim.simulate_genome_mixture(mixture_file, None, params)
    with open(mixture_file, 'rb') as f:
        mixture = pickle.load(f)
    with open(fixture['mixture_file'], 'rb') as f:
        port_mixture = pickle.load(f)
    np.testing.assert_array_equal(mixture.cn, port_mixture.cn)
    np.testing.assert_array_equal(mixture.segment_end,
                                  port_mixture.segment_end)
    np.testing.assert_array_equal(mixture.frac, port_mixture.frac)
    print('RUN_JAX = ' + repr(dict(
        counts=digest, segments=digest['rows'],
        evaluation=jax_evaluation(mixture, results),
        **jax_fit_choice(results), **phase11_near(workdir))))


if __name__ == '__main__':
    if sys.argv[1:2] != ['--phase11'] or len(sys.argv) not in (3, 4) or \
            sys.argv[3:] not in ([], ['--near']):
        sys.exit('usage: python tests/test_torch_run.py --phase11 WORKDIR '
                 '[--near]')
    sys.path.insert(0, REPO)
    if sys.argv[3:]:
        print('RUN_JAX.update(' + repr(phase11_near(sys.argv[2])) + ')')
    else:
        phase11_reference(sys.argv[2])
