"""The multi-tumour ``run`` of the port against the JAX package's, on the
CPU: the cohort's split over processes
(``parallel.distributed.cohort_partition``), the cohort fit
(``analysis.pipeline.fit_many_cohort``), the cohort fit workflow
(``workflow.create_fit_cohort_workflow``) and the two-tumour
``create_remixt_bam_workflow``.

The fits are float64 on two samples of ``simulations/simple`` (N=40),
held to the JAX package's fit of each sample on its single-device route
(``use_cohort_sharding`` and ``use_device_mesh`` off: the JAX package's
mesh route is a known defect of the reference) at the tolerances of
``test_torch_pipeline.py``: h rtol 1e-7, ELBO rtol 1e-8, copy number
exact. The port's two-worker route must equal its sequential one bit for
bit. The two-tumour run is ``test_torch_run.py``'s at its small size with
a second tumour BAM (``make_run_fixture(..., tumour_b=True)``); its tables
and experiments must equal the JAX package's, integers exactly and floats
at rtol 1e-12.

Run as a script, ``python tests/test_torch_cohort.py --phase13 WORKDIR``
makes ``chip_smoke.py`` phase 13's inputs (phase 11's with the second
tumour BAM), runs the JAX package's whole two-tumour
``create_remixt_bam_workflow`` on them (its fit at the defaults, on the
CPU; one JAX device, so its cohort fit takes its sequential route) and the
port's up to the count tables, checks that the tables are equal, and
prints per tumour what ``python tests/test_torch_run.py --phase11``
prints for one: the constants ``COHORT_JAX`` of ``chip_smoke.py``. The
refits near each tumour's JAX choice run in two processes at once. With
``--near`` it makes only the refits, from a WORKDIR where such a run has
finished.
"""

import copy
import json
import os
import pickle
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# run as a script, the packages are found at the repository's root
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from remixt_tpu.analysis import pipeline as jax_pipeline
from remixt_tpu.config import get_sample_config as jax_sample_config
from remixt_tpu.parallel import distributed as jax_distributed
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch.analysis import pipeline as torch_pipeline
from remixt_tpu_torch.parallel import distributed as torch_distributed

from test_cli import _write_tables
from test_torch_pipeline import assert_results_match
from test_torch_run import (CHROMOSOMES, CONFIG as RUN_CONFIG, DEPTHS,
                            MIXTURE, assert_experiments_equal,
                            assert_frame_equal, chip_smoke, jax_config,
                            jax_evaluation, jax_fit_choice,
                            jax_near_references, pinned_depths, read)
from test_torch_workflow import assert_stores_match

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

SAMPLES = {'sampleA': 22, 'sampleB': 26}
CONFIG = {
    'max_copy_number': 6,
    'num_em_iter': 2,
    'num_update_iter': 2,
    'likelihood_min_segment_length': 1.0,
    'engine_dtype': 'float64',
    'min_ploidy': 1.0,
    'max_ploidy': 8.0,
    'h_normal': 0.08,
    'h_tumour': 0.075,
    'tumour_mix_fractions': [0.45, 0.2],
    'divergence_weights': [1e-6, 1e-8],
    # sampleB's grid has two restarts, and its fit one VI sweep an EM
    # iteration
    'sample_specific': {'sampleB': {'tumour_mix_fractions': [0.3],
                                    'num_update_iter': 1}},
}
# the JAX package's single-device route
JAX_CONFIG = dict(CONFIG, use_cohort_sharding=False, use_device_mesh=False)
COHORT = ('tumour', 'tumour_b')


# ---------------------------------------------------------------------------
# cohort_partition
# ---------------------------------------------------------------------------

IDS = {'letters': ['c', 'a', 'b', 'e', 'd'],
       'mixed': [3, '10', 2, 'x', 1],
       'one': ['only'],
       'none': []}


@pytest.mark.parametrize('ids', list(IDS))
@pytest.mark.parametrize('process_id, process_count',
                         [(0, 1), (0, 2), (1, 2), (0, 3), (2, 3), (3, 4)])
def test_cohort_partition_matches_jax(ids, process_id, process_count):
    assert torch_distributed.cohort_partition(
        IDS[ids], process_id, process_count) == \
        jax_distributed.cohort_partition(IDS[ids], process_id, process_count)


def test_cohort_partition_reads_the_process_group(monkeypatch):
    """Without a process group this is the only process; with one, its
    rank and size deal the samples."""
    ids = IDS['letters']
    assert torch_distributed.cohort_partition(ids) == sorted(ids)
    dist = torch.distributed
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_rank', lambda: 1)
    monkeypatch.setattr(dist, 'get_world_size', lambda: 2)
    assert torch_distributed.cohort_partition(ids) == ['b', 'd']
    assert torch_distributed.cohort_partition(ids, process_id=0) == \
        ['a', 'c', 'e']


# ---------------------------------------------------------------------------
# fit_many_cohort
# ---------------------------------------------------------------------------

def write_experiments(tmp, seeds):
    """Each sample's simulated tables as TSVs and both packages'
    experiments made from them: {sample: (JAX pickle, port pickle)}."""
    from remixt_tpu.analysis import experiment as jax_experiment
    from remixt_tpu_torch.analysis import experiment as torch_experiment
    files = {}
    for sample_id, seed in seeds.items():
        data = sim.simulate_experiment(
            N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
            negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=seed)
        directory = tmp / sample_id
        directory.mkdir()
        count_file, breakpoint_file = _write_tables(directory, data)
        files[sample_id] = tuple(
            str(directory / '{}.pickle'.format(name)) for name in
            ('jax', 'torch'))
        jax_experiment.create_experiment(count_file, breakpoint_file,
                                         files[sample_id][0])
        torch_experiment.create_experiment(count_file, breakpoint_file,
                                           files[sample_id][1])
    return files


def load(filename):
    with open(filename, 'rb') as f:
        return pickle.load(f)


@pytest.fixture(scope='module')
def cohort(tmp_path_factory):
    """Both samples' experiments and grids (the JAX package's ``init``
    with each sample's config), the JAX package's cohort fit, and the
    port's on one CPU device and on two."""
    tmp = tmp_path_factory.mktemp('torch_cohort')
    files = write_experiments(tmp, SAMPLES)
    jax_experiments = {s: load(f[0]) for s, f in files.items()}
    experiments = {s: load(f[1]) for s, f in files.items()}
    grids = {s: jax_pipeline.init(str(tmp / '{}_init.h5'.format(s)),
                                  files[s][0], jax_sample_config(CONFIG, s))
             for s in SAMPLES}
    ref = jax_pipeline.fit_many_cohort(jax_experiments, grids, JAX_CONFIG)
    fits = {n: torch_pipeline.fit_many_cohort(
        experiments, grids, CONFIG, devices=['cpu'] * n) for n in (1, 2)}
    return dict(experiments=experiments, grids=grids, ref=ref, fits=fits)


def test_fit_many_cohort_matches_jax(cohort):
    got = cohort['fits'][1]
    assert list(got) == sorted(SAMPLES)
    for sample_id in SAMPLES:
        assert_results_match(got[sample_id], cohort['ref'][sample_id])


def test_two_workers_equal_one_bit_for_bit(cohort):
    one, two = cohort['fits'][1], cohort['fits'][2]
    assert list(two) == list(one)
    for sample_id in one:
        assert list(two[sample_id]) == list(one[sample_id])
        for init_id, ref in one[sample_id].items():
            got = two[sample_id][init_id]
            label = '{} restart {}'.format(sample_id, init_id)
            for name in ('h', 'cn', 'p_outlier_total', 'p_outlier_allele'):
                np.testing.assert_array_equal(got[name], ref[name],
                                              err_msg=label + ' ' + name)
            assert got['stats'] == ref['stats'], label
            assert set(got['brk_cn']) == set(ref['brk_cn']), label
            for bp_id, cn in ref['brk_cn'].items():
                np.testing.assert_array_equal(got['brk_cn'][bp_id], cn,
                                              err_msg=label)


def test_sample_specific_override_reaches_grid_and_fit(cohort):
    """sampleB's override shrinks its grid at init and its VI sweeps in
    the fit: the cohort's fit of it is not its fit under the shared
    config."""
    grids = cohort['grids']
    assert len(grids['sampleA']) == 4 and len(grids['sampleB']) == 2
    got = cohort['fits'][1]['sampleB']
    assert list(got) == list(grids['sampleB'])
    shared = torch_pipeline.fit_many(
        cohort['experiments']['sampleB'], grids['sampleB'], CONFIG,
        device='cpu')
    for init_id in got:
        assert got[init_id]['stats']['elbo'] != \
            shared[init_id]['stats']['elbo'], init_id


@pytest.mark.parametrize('config, workers', [
    ({}, 2),
    ({'use_cohort_sharding': False}, 1),
    ({'batch_restarts': False}, 1),
    ({'optimal_initialization': True}, 1),
], ids=['sharded', 'sharding off', 'not batched',
        'optimal initialization'])
def test_each_device_has_one_worker(monkeypatch, config, workers):
    """Samples are dealt in ``cohort_partition``'s order to the devices,
    one worker thread a device fitting its samples one after another; the
    sequential routes fit every sample on the first device in the calling
    thread."""
    calls = []
    lock = threading.Lock()
    running = {}

    def fake_fit_many(experiment, grid, sample_config, device=None):
        thread = threading.get_ident()
        with lock:
            running[device] = running.get(device, 0) + 1
            assert running[device] == 1, 'two fits on {}'.format(device)
            calls.append((experiment, str(device), thread,
                          sample_config['marker']))
        time.sleep(0.02)
        with lock:
            running[device] -= 1
        return {'fit of': experiment}

    monkeypatch.setattr(torch_pipeline, 'fit_many', fake_fit_many)
    ids = ['s4', 's1', 's0', 's3', 's2']
    devices = [torch.device('cpu'), 'cpu']
    # a distinct object per device, so that a fit's device names its worker
    devices[1] = type('SecondCpu', (), {'type': 'cpu',
                                        '__str__': lambda self: 'cpu#1'})()
    monkeypatch.setattr(torch_pipeline, 'resolve_device', lambda d: d)
    got = torch_pipeline.fit_many_cohort(
        {s: s for s in ids}, {s: {} for s in ids},
        dict(config, marker='shared',
             sample_specific={s: {'marker': s} for s in ids}),
        devices=devices)
    assert list(got) == sorted(ids)
    assert got == {s: {'fit of': s} for s in ids}
    assert all(marker == sample for sample, _, _, marker in calls)
    by_device = {}
    for sample, device, thread, _ in calls:
        by_device.setdefault(device, []).append((sample, thread))
    if workers == 1:
        assert list(by_device) == ['cpu']
        assert [s for s, _ in by_device['cpu']] == sorted(ids)
        assert {t for _, t in by_device['cpu']} == {threading.get_ident()}
    else:
        assert [s for s, _ in by_device['cpu']] == ['s0', 's2', 's4']
        assert [s for s, _ in by_device['cpu#1']] == ['s1', 's3']
        threads = [{t for _, t in by_device[d]} for d in ('cpu', 'cpu#1')]
        assert all(len(t) == 1 for t in threads)
        assert threads[0] != threads[1]


def test_fit_many_cohort_without_cuda_raises(cohort, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        torch_pipeline.fit_many_cohort(
            cohort['experiments'], cohort['grids'], CONFIG)


# ---------------------------------------------------------------------------
# create_fit_cohort_workflow
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def cohort_workflow(tmp_path_factory):
    import remixt_tpu.workflow as jax_workflow
    from remixt_tpu_torch import workflow as torch_workflow

    tmp = tmp_path_factory.mktemp('torch_cohort_workflow')
    files = write_experiments(tmp, SAMPLES)
    results = {}
    for index, (name, module, config, kwargs) in enumerate((
            ('jax', jax_workflow, JAX_CONFIG, {}),
            ('torch', torch_workflow, CONFIG, {'device': 'cpu'}))):
        results[name] = {s: str(tmp / '{}_{}.h5'.format(name, s))
                         for s in SAMPLES}

        def flow(module=module, index=index, name=name, config=config,
                 kwargs=kwargs):
            return module.create_fit_cohort_workflow(
                {s: f[index] for s, f in files.items()}, results[name],
                config, str(tmp / 'ref'), str(tmp / name / 'tmp'), **kwargs)
        flow().run(str(tmp / name / 'work'))
        if name == 'torch':
            rerun = flow
    return dict(tmp=tmp, results=results, rerun=rerun)


@pytest.mark.parametrize('sample_id', list(SAMPLES))
def test_cohort_workflow_stores_match_jax(cohort_workflow, sample_id):
    results = cohort_workflow['results']
    assert_stores_match(results['jax'][sample_id],
                        results['torch'][sample_id])


def test_cohort_workflow_rerun_is_a_no_op(cohort_workflow, monkeypatch):
    """The fit task declares no outputs; run again, the scheduler skips it
    by its done sentinel and return pickle, as every other task."""
    def refuse(*args, **kwargs):
        raise AssertionError('the cohort fit ran again')
    monkeypatch.setattr(torch_pipeline, 'fit_many_cohort', refuse)
    monkeypatch.setattr(torch_pipeline, 'init', refuse)
    monkeypatch.setattr(torch_pipeline, 'collate', refuse)
    stores = cohort_workflow['results']['torch'].values()
    before = [os.path.getmtime(path) for path in stores]
    t0 = time.time()
    cohort_workflow['rerun']().run(
        str(cohort_workflow['tmp'] / 'torch' / 'work'))
    assert time.time() - t0 < 10.0
    assert [os.path.getmtime(path) for path in stores] == before


# ---------------------------------------------------------------------------
# the two-tumour run
# ---------------------------------------------------------------------------

def sample_tables(tumour):
    """The tables both workflows write for one tumour, under the raw
    directory."""
    return ['tmp/counts/segment_counts/{}.tsv'.format(tumour),
            'tmp/counts/allele_counts/{}.tsv'.format(tumour),
            'tmp/counts/phased_allele_counts/{}.tsv'.format(tumour),
            'tmp/rawcounts/{}.tsv'.format(tumour),
            'tmp/bias/{}/biases.tsv'.format(tumour),
            'counts/sample_{}.tsv'.format(tumour)]


TABLES = ['segments.tsv', 'haplotypes.tsv'] + [
    name for tumour in COHORT for name in sample_tables(tumour)]


def cohort_workflow_of(module, fixture, raw, config, results, **kwargs):
    return module.create_remixt_bam_workflow(
        fixture['breakpoint_file'], fixture['bams'], results, raw, config,
        fixture['ref_data_dir'], normal_id='normal', **kwargs)


def without_fits(workflow):
    """The tasks up to the experiments."""
    workflow.tasks = [t for t in workflow.tasks
                      if '/fit_cohort_workflow/' not in t.name
                      and '/fit_model_' not in t.name
                      and 'ploidy' not in t.name]
    return workflow


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import remixt_tpu.workflow as jax_workflow
    import remixt_tpu_torch.workflow as torch_workflow

    cs = chip_smoke()
    root = tmp_path_factory.mktemp('torch_cohort_run')
    fixture = cs.make_run_fixture(str(root / 'fixture'), CHROMOSOMES,
                                  depths=DEPTHS, with_hdf5=True,
                                  mixture_params=MIXTURE, tumour_b=True)
    bin_dir = cs.write_standin_tools(str(root / 'bin'))
    path = os.environ['PATH']
    os.environ['PATH'] = bin_dir + os.pathsep + path
    try:
        raw = {'jax': str(root / 'jax'), 'torch': str(root / 'torch')}
        np.random.seed(cs.RUN_NUMPY_SEED)
        without_fits(cohort_workflow_of(
            jax_workflow, fixture, raw['jax'],
            jax_config(fixture, RUN_CONFIG),
            {t: os.path.join(raw['jax'], 'results_{}.h5'.format(t))
             for t in COHORT})).run(raw['jax'])
        # each tumour's depths pinned by its own override: two restarts
        config = dict(fixture['config'], **RUN_CONFIG, sample_specific={
            t: pinned_depths(
                os.path.join(raw['jax'], 'counts', 'sample_{}.tsv'.format(t)),
                fixture['breakpoint_file'], root) for t in COHORT})
        results = {t: os.path.join(raw['torch'], 'results_{}.h5'.format(t))
                   for t in COHORT}
        np.random.seed(cs.RUN_NUMPY_SEED)
        cohort_workflow_of(torch_workflow, fixture, raw['torch'], config,
                           results, device='cpu').run(raw['torch'])
    finally:
        os.environ['PATH'] = path
    return dict(fixture=fixture, raw=raw, results=results, bin_dir=bin_dir,
                config=config)


@pytest.mark.parametrize('name', TABLES)
def test_two_tumour_tables_match_jax(runs, name):
    ref = read(runs['raw']['jax'], name)
    assert len(ref) > 0, name
    assert_frame_equal(read(runs['raw']['torch'], name), ref, name)


def test_the_tumours_differ(runs):
    """tumour_b is its own sample: its reads and its count table are not
    tumour's."""
    counts = [read(runs['raw']['torch'], 'counts/sample_{}.tsv'.format(t))
              for t in COHORT]
    assert not np.array_equal(counts[0]['readcount'].values,
                              counts[1]['readcount'].values)
    mixtures = [load(runs['fixture']['mixture_files'][t]) for t in COHORT]
    np.testing.assert_array_equal(mixtures[1].frac,
                                  np.asarray(mixtures[0].frac)[[0, 2, 1]])
    np.testing.assert_array_equal(mixtures[1].cn, mixtures[0].cn)


def test_tumour_b_leaves_the_other_bams_as_they_were(runs, tmp_path):
    """The second tumour's reads are drawn after the others', so the
    tumour and normal BAMs are those of a fixture without it."""
    import hashlib
    fixture = chip_smoke().make_run_fixture(
        str(tmp_path / 'fixture'), CHROMOSOMES, depths=DEPTHS,
        mixture_params=MIXTURE)
    assert set(fixture['bams']) == {'tumour', 'normal'}
    for sample, path in fixture['bams'].items():
        digests = [hashlib.sha256(open(p, 'rb').read()).hexdigest()
                   for p in (path, runs['fixture']['bams'][sample])]
        assert digests[0] == digests[1], sample
    assert runs['fixture']['pairs']['tumour_b'] > 0


@pytest.mark.parametrize('tumour', COHORT)
def test_two_tumour_experiments_match_jax(runs, tumour):
    name = os.path.join('experiment', 'sample_{}.pickle'.format(tumour))
    assert_experiments_equal(load(os.path.join(runs['raw']['torch'], name)),
                             load(os.path.join(runs['raw']['jax'], name)))


@pytest.mark.parametrize('tumour', COHORT)
def test_two_tumour_run_writes_both_stores(runs, tumour):
    """The cohort fit ran on the CPU over each tumour's grid of two (its
    own pinned depths) and wrote its results store with the JAX package's
    keys."""
    from remixt_tpu_torch.io.store import read_store
    tables = read_store(runs['results'][tumour])
    restarts = {k.split('/')[1] for k in tables
                if k.startswith('solutions/')}
    assert len(restarts) == 2
    assert {'stats', 'cn', 'mix', 'brk_cn', 'read_depth',
            'minor_modes'} <= set(tables)
    assert np.all(np.isfinite(tables['stats']['elbo']))
    fit_dir = os.path.join(runs['raw']['torch'], 'tmp', 'fit', 'fit_results',
                           tumour)
    assert sorted(os.listdir(fit_dir)) == ['fit_0.pickle', 'fit_1.pickle']


def test_two_tumour_run_without_cuda_raises(runs, monkeypatch, tmp_path):
    """Without a device the two-tumour run makes both count tables, then
    raises when it reaches the cohort fit; no results store is written."""
    import remixt_tpu_torch.ui.run

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setenv('PATH', runs['bin_dir'] + os.pathsep
                       + os.environ['PATH'])
    config = tmp_path / 'config.yaml'
    config.write_text(json.dumps(runs['config']))
    fixture = runs['fixture']
    raw = tmp_path / 'raw'
    results = [tmp_path / 'results_{}.h5'.format(t) for t in COHORT]
    np.random.seed(chip_smoke().RUN_NUMPY_SEED)
    with pytest.raises(RuntimeError, match='CUDA'):
        remixt_tpu_torch.ui.run.run(
            ref_data_dir=fixture['ref_data_dir'], raw_data_dir=str(raw),
            breakpoint_file=fixture['breakpoint_file'],
            tumour_sample_ids=list(COHORT),
            tumour_bam_files=[fixture['bams'][t] for t in COHORT],
            results_files=[str(r) for r in results],
            normal_sample_id='normal',
            normal_bam_file=fixture['bams']['normal'], config=str(config),
            maxjobs=1)
    for tumour in COHORT:
        assert (raw / 'counts' / 'sample_{}.tsv'.format(tumour)).exists()
    assert not any(r.exists() for r in results)


# ---------------------------------------------------------------------------
# phase 13's bookkeeping in chip_smoke.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('args, sample', [
    (('raw/seqdata/sample_tumour_b', 'ref/genome.fa'), 'tumour_b'),
    (('x', {'c': 'raw/tmp/bias/tumour/biases.tsv'}), 'tumour'),
    ((['in/normal.bam'], 'out/normal_x'), 'normal'),
    (({'tumour': 'a', 'tumour_b': 'b'}, 'c'), None),
    (('raw/segments.tsv', 3, None), None),
], ids=['tumour_b', 'tumour', 'normal', 'both', 'none'])
def test_sample_of(args, sample):
    assert chip_smoke().sample_of(args) == sample


def test_per_sample_times_and_waves():
    cs = chip_smoke()
    run = dict(times={'sample_gc': [1.0, 2.0], 'phase': [3.0],
                      'fit': [4.0, 5.0], 'extract': [0.5, 0.25, 0.125]},
               samples={'sample_gc': ['tumour', 'tumour_b'],
                        'phase': [None], 'fit': [None, None],
                        'extract': ['normal', 'tumour', 'normal']})
    assert cs.per_sample_times(run, ['tumour_b', 'tumour']) == {
        'sample_gc': {'tumour': 1.0, 'tumour_b': 2.0},
        'phase': {'all': 3.0}, 'fit': {'tumour': 4.0, 'tumour_b': 5.0},
        'extract': {'normal': 0.625, 'tumour': 0.25}}
    # fits of 9 and 8 restarts in waves of 8: 2 + 1 and 1 + 1 marks
    marks = [0.0, 1.0, 3.0, 10.0, 14.0]
    assert cs.split_waves(marks, [9, 8]) == [[1.0, 2.0], [4.0]]


def test_fits_differ():
    cs = chip_smoke()

    def fit(h, elbo, cn=0):
        return {'h': np.array(h), 'stats': {'elbo': elbo},
                'cn': np.full((2, 3, 2), cn), 'brk_cn': {7: np.ones(3)}}
    ref = {0: fit([0.1, 0.2], -5.0), 1: fit([0.3, 0.4], -6.0)}
    assert cs.fits_differ(dict(ref), ref) == []
    assert cs.fits_differ({0: ref[0], 1: fit([0.3, 0.4], -6.0, cn=1)},
                          ref) == [1]
    assert cs.fits_differ({0: fit([0.1, np.nextafter(0.2, 1)], -5.0),
                           1: ref[1]}, ref) == [0]
    assert cs.fits_differ({0: fit([0.1, 0.2], np.nextafter(-5.0, 0)),
                           1: ref[1]}, ref) == [0]
    assert cs.fits_differ({1: ref[1]}, ref) != []


# ---------------------------------------------------------------------------
# phase 13's reference numbers
# ---------------------------------------------------------------------------

def phase13_near_one(workdir, tumour):
    """``jax_near_references`` of one tumour of a finished ``--phase13``
    WORKDIR."""
    raw = os.path.join(workdir, 'jax')
    return jax_near_references(
        os.path.join(raw, 'experiment', 'sample_{}.pickle'.format(tumour)),
        os.path.join(raw, 'results_{}.h5'.format(tumour)),
        load(os.path.join(workdir, 'jax_mixture_{}.pickle'.format(tumour))),
        os.path.join(workdir, 'near_{}'.format(tumour)))


def phase13_near(workdir):
    """Both tumours' refits, in two processes at once: {tumour: refits}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(
            max_workers=len(COHORT),
            mp_context=multiprocessing.get_context('spawn')) as pool:
        futures = {t: pool.submit(phase13_near_one, workdir, t)
                   for t in COHORT}
        return {t: future.result() for t, future in futures.items()}


def phase13_reference(workdir, chromosome_lengths=None, mixture_params=None,
                      overrides=None):
    """Run the JAX package's whole two-tumour run path on phase 13's
    inputs and the port's up to the count tables; print the constants of
    ``COHORT_JAX``. The arguments shrink the run (a rehearsal of the
    script)."""
    import remixt_tpu.workflow as jax_workflow
    import remixt_tpu.simulations.pipeline as jax_sim
    import remixt_tpu_torch.workflow as torch_workflow

    cs = chip_smoke()
    chromosome_lengths = chromosome_lengths or cs.RUN_CHROMOSOMES
    overrides = overrides or {}
    t0 = time.time()
    fixture = cs.make_run_fixture(
        os.path.join(workdir, 'fixture'), chromosome_lengths,
        with_hdf5=True, mixture_params=mixture_params, tumour_b=True)
    print('fixture', fixture['pairs'], fixture['times'],
          round(time.time() - t0, 1), flush=True)
    os.environ['PATH'] = cs.write_standin_tools(
        os.path.join(workdir, 'bin')) + os.pathsep + os.environ['PATH']

    raw = {'jax': os.path.join(workdir, 'jax'),
           'torch': os.path.join(workdir, 'torch')}
    for path in raw.values():
        shutil.rmtree(path, ignore_errors=True)
    results = {t: os.path.join(raw['jax'], 'results_{}.h5'.format(t))
               for t in COHORT}
    np.random.seed(cs.RUN_NUMPY_SEED)
    t0 = time.time()
    cohort_workflow_of(jax_workflow, fixture, raw['jax'],
                       jax_config(fixture, overrides), results).run(raw['jax'])
    print('jax run', round(time.time() - t0, 1), flush=True)

    np.random.seed(cs.RUN_NUMPY_SEED)
    t0 = time.time()
    without_fits(cohort_workflow_of(
        torch_workflow, fixture, raw['torch'],
        dict(fixture['config'], **overrides),
        {t: os.path.join(raw['torch'], 'results_{}'.format(t))
         for t in COHORT}, device='cpu')).run(raw['torch'])
    print('port run to the counts', round(time.time() - t0, 1), flush=True)
    for name in TABLES:
        assert_frame_equal(read(raw['torch'], name), read(raw['jax'], name),
                           name)
    print('count tables equal', flush=True)

    # the JAX package's own simulation of the mixture is the port's; the
    # second region's truth is it with the clones' fractions swapped
    params = cs.run_mixture_params(chromosome_lengths)
    params.update(mixture_params or {})
    mixture_file = os.path.join(workdir, 'jax_mixture_tumour.pickle')
    jax_sim.simulate_genome_mixture(mixture_file, None, params)
    mixtures = {'tumour': load(mixture_file)}
    mixtures['tumour_b'] = copy.copy(mixtures['tumour'])
    mixtures['tumour_b'].frac = np.asarray(mixtures['tumour'].frac)[[0, 2, 1]]
    with open(os.path.join(workdir, 'jax_mixture_tumour_b.pickle'),
              'wb') as f:
        pickle.dump(mixtures['tumour_b'], f)
    for tumour in COHORT:
        port_mixture = load(fixture['mixture_files'][tumour])
        for name in ('cn', 'segment_end', 'frac'):
            np.testing.assert_array_equal(getattr(mixtures[tumour], name),
                                          getattr(port_mixture, name))

    near = phase13_near(workdir)
    cohort = {}
    for tumour in COHORT:
        digest = cs.count_table_digest(os.path.join(
            raw['jax'], 'counts', 'sample_{}.tsv'.format(tumour)))
        cohort[tumour] = dict(
            counts=digest, segments=digest['rows'],
            evaluation=jax_evaluation(mixtures[tumour], results[tumour]),
            **jax_fit_choice(results[tumour]), **near[tumour])
    print('COHORT_JAX = ' + repr(cohort))
    return cohort


if __name__ == '__main__':
    if sys.argv[1:2] != ['--phase13'] or len(sys.argv) not in (3, 4) or \
            sys.argv[3:] not in ([], ['--near']):
        sys.exit('usage: python tests/test_torch_cohort.py --phase13 '
                 'WORKDIR [--near]')
    if sys.argv[3:]:
        print('near = ' + repr(phase13_near(sys.argv[2])))
    else:
        phase13_reference(sys.argv[2])
