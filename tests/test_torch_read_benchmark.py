"""The port's read-level benchmark path against the JAX package's, on the
CPU: ``create_simulations`` from a reference's FASTA index, the read and
resample simulation workflows, ``ReMixTTool``, breakpoint matching, the
read benchmark's runner end to end with the four tools (ReMixT, and
TITAN, THetA2 and cloneHD through ``chip_smoke.py``'s stand-ins), and the
resample runner with the external tools.

The inputs are ``chip_smoke.make_read_fixture``'s at a small size (two
chromosomes of 3 and 2 Mb, an impute2 panel of 40 haplotypes at the
reference's SNPs, ``benchmark/sim_defs.yaml``'s simulation with N=40 and
fewer events, h_total 0.05), made from seeds. The simulation workflows'
outputs must be equal to the JAX workflows' exactly (tolerance 0); the
runner's merged evaluation must have the JAX package's columns and, on
the port's results store, the JAX evaluation's values at rtol 1e-12.

Run as a script, ``python tests/test_torch_read_benchmark.py --phase12
WORKDIR [--build GRCh37|GRCh38]`` makes ``chip_smoke.py`` phase 12's
inputs (the three chromosomes of ``RUN_CHROMOSOMES`` at ``READ_H_TOTAL``,
on the build ``READ_GENOME_VERSION`` unless ``--build`` names another),
runs the JAX package's read benchmark on them
(``benchmark/run_read_benchmark.py``, its fit at the defaults, on the
CPU) and the port's up to the count table, checks that
the two packages' seqdata and count tables are equal, and prints the
constants ``READ_JAX`` of ``chip_smoke.py`` (with the restart the JAX fit
chose, every restart's ELBO, the JAX package's refits of the restarts
near the chosen one: ``test_torch_run.jax_fit_choice`` and
``jax_near_references``, and each external tool's ``tool_record``).
Nothing is seeded between the tasks of either run. With ``--near`` it
makes only the refits, from a WORKDIR where such a run has finished; with
``--tools`` it runs the JAX benchmark with the external tools alone and
prints ``READ_JAX['tools']`` (~2 min).
"""

import filecmp
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
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

CHROMOSOMES = {'1': 3000000, '2': 2000000}
H_TOTAL = 0.05
N = 40
SIM_OVERRIDES = dict(num_ancestral_events=10, num_descendent_events=5,
                     num_false_breakpoints=3)
CONFIG = dict(segment_length=100000, shapeit_num_samples=10,
              sample_gc_num_positions=100000, num_em_iter=1,
              num_update_iter=1, tumour_mix_fractions=[0.45],
              divergence_weights=[1e-7])


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def chip_smoke():
    return load_module('chip_smoke', os.path.join(REPO, 'chip_smoke.py'))


def jax_config(fixture, overrides=None):
    """The JAX package reads the mappability store in its HDF5 form."""
    return dict(fixture['config'], **(overrides or {}),
                mappability_filename=(
                    fixture['config']['mappability_filename'] + '.h5'))


def sim_params(fixture):
    import remixt_tpu_torch.simulations.pipeline as torch_sim
    params = torch_sim.create_simulations(
        fixture['sim_defs'], fixture['config'], fixture['ref_data_dir'])
    assert list(params) == [chip_smoke().READ_SIM_ID]
    return params[chip_smoke().READ_SIM_ID]


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    cs = chip_smoke()
    root = tmp_path_factory.mktemp('read_fixture')
    made = cs.make_read_fixture(str(root), CHROMOSOMES, H_TOTAL, N=N,
                                with_hdf5=True, sim_overrides=SIM_OVERRIDES)
    made['root'] = root
    return made


def simulation_files(directory, suffix):
    return dict(
        normal=os.path.join(directory, 'normal' + suffix),
        tumour=os.path.join(directory, 'tumour' + suffix),
        mixture=os.path.join(directory, 'mixture.pickle'),
        breakpoints=os.path.join(directory, 'breakpoints.tsv'))


@pytest.fixture(scope='module')
def simulated(fixture):
    """Both packages' read simulation workflows on the fixture: {package:
    (files, germline store)}; the port's stores as directories."""
    import remixt_tpu.simulations.workflow as jax_workflow
    import remixt_tpu_torch.simulations.workflow as torch_workflow
    from remixt_tpu_torch.io import store

    root = fixture['root']
    params = sim_params(fixture)
    out = {}
    for name, module, suffix in (('jax', jax_workflow, '.h5'),
                                 ('torch', torch_workflow, '')):
        directory = str(root / 'sim_{}'.format(name))
        files = simulation_files(directory, suffix)
        os.makedirs(directory, exist_ok=True)
        config = (jax_config(fixture) if name == 'jax'
                  else fixture['config'])
        original = store.store_name
        store_name = (lambda stem: stem) if name == 'torch' else original
        torch_workflow.store_name = store_name
        try:
            module.create_read_simulation_workflow(
                params, files['normal'], files['tumour'], files['mixture'],
                files['breakpoints'], config, fixture['ref_data_dir'],
                os.path.join(directory, 'sim')).run(
                    os.path.join(directory, 'work'))
        finally:
            torch_workflow.store_name = original
        germline = os.path.join(directory, 'sim', 'germline_alleles'
                                + suffix)
        out[name] = (files, germline)
    return out


def test_create_simulations_from_the_reference_equals_jax(fixture,
                                                          tmp_path):
    """Lengths from the FASTA index: the chromosomes of the sim defs, or
    by default 1 to 22; the same dicts in the same key order."""
    import remixt_tpu.simulations.pipeline as jax_sim
    import remixt_tpu_torch.simulations.pipeline as torch_sim
    ref_dir = tmp_path / 'ref'
    ref_dir.mkdir()
    fai = ref_dir / 'genome.fa.fai'
    fai.write_text(''.join('{}\t{}\t0\t60\t61\n'.format(c, n) for c, n in
                           dict(chip_smoke().AUTOSOMES, X=155270560).items()))
    config = {'genome_fai_filename': str(fai)}
    with open(fixture['sim_defs']) as f:
        sim_defs = yaml.safe_load(f)
    for chromosomes in (['20', '21', '22'], None):
        defs = json.loads(json.dumps(sim_defs))
        del defs['defaults']['chromosomes']
        if chromosomes is not None:
            defs['defaults']['chromosomes'] = chromosomes
        defs['simulations']['other'] = dict(
            num_simulations=2, num_replicates=2, random_seed_start=5,
            h_total=[0.1, 0.2])
        path = tmp_path / 'defs.yaml'
        path.write_text(json.dumps(defs))
        cfg = dict(config, chromosomes=chromosomes or [
            str(c) for c in range(1, 23)] + ['X'])
        ref = jax_sim.create_simulations(str(path), cfg, str(ref_dir))
        got = torch_sim.create_simulations(str(path), cfg, str(ref_dir))
        assert got == ref
        assert list(got) == list(ref)
        for key in ref:
            assert list(got[key]) == list(ref[key]), key
            assert list(got[key]['chromosome_lengths']) == \
                (chromosomes or [str(c) for c in range(1, 23)])
    with pytest.raises(ValueError, match='chromosome_lengths required'):
        torch_sim.create_simulations(str(path), cfg, None)


def test_read_simulation_workflow_equals_jax(simulated):
    """The germline alleles, the mixture, the breakpoint table and both
    samples' seqdata, the port's stores as directories."""
    from test_torch_seqread import assert_same_alleles, assert_same_seqdata
    import remixt_tpu.simulations.pipeline as jax_sim
    import remixt_tpu_torch.simulations.pipeline as torch_sim

    (jax_files, jax_germline), (files, germline) = (simulated['jax'],
                                                    simulated['torch'])
    assert os.path.isdir(germline) and os.path.isdir(files['normal'])
    for chromosome in CHROMOSOMES:
        ref = jax_sim.load_germline_alleles(jax_germline, chromosome)
        assert_same_alleles(
            torch_sim.load_germline_alleles(germline, chromosome),
            ref[list(torch_sim.GERMLINE_COLUMNS)])
    for sample in ('normal', 'tumour'):
        assert_same_seqdata(files[sample], jax_files[sample])
    with open(files['breakpoints'], 'rb') as f, \
            open(jax_files['breakpoints'], 'rb') as g:
        assert f.read() == g.read()
    with open(files['mixture'], 'rb') as f, \
            open(jax_files['mixture'], 'rb') as g:
        got, ref = pickle.load(f), pickle.load(g)
    np.testing.assert_array_equal(got.cn, ref.cn)
    np.testing.assert_array_equal(got.frac, ref.frac)


def test_resample_simulation_workflow_equals_jax(fixture, simulated):
    """Each package resamples the JAX simulation's seqdata to the mixture
    of another seed; the port's output in both store forms."""
    from test_torch_seqread import assert_same_seqdata
    import remixt_tpu.simulations.workflow as jax_workflow
    import remixt_tpu_torch.simulations.workflow as torch_workflow

    root = fixture['root']
    params = dict(sim_params(fixture), random_seed=77)
    sources = simulated['jax'][0]
    out = {}
    for name, module, suffix in (('jax', jax_workflow, '.h5'),
                                 ('torch', torch_workflow, '.h5'),
                                 ('torch_dir', torch_workflow, '')):
        directory = str(root / 'resample_{}'.format(name))
        files = simulation_files(directory, suffix)
        config = (jax_config(fixture) if name == 'jax'
                  else fixture['config'])
        module.create_resample_simulation_workflow(
            params, sources['normal'], sources['tumour'], files['normal'],
            files['tumour'], files['mixture'], files['breakpoints'], config,
            fixture['ref_data_dir'], os.path.join(directory, 'sim')).run(
                os.path.join(directory, 'work'))
        out[name] = files
    for name in ('torch', 'torch_dir'):
        for sample in ('normal', 'tumour'):
            assert_same_seqdata(out[name][sample], out['jax'][sample])


def test_remixt_tool_refuses_two_tumours_and_passes_its_device(tmp_path):
    from remixt_tpu_torch import wrappers, workflow
    tool = wrappers.catalog['remixt']({}, str(tmp_path), device='cpu')
    with pytest.raises(ValueError, match='exactly one tumour'):
        tool.create_workflow(
            {'n': 'n.h5', 't1': 't1.h5', 't2': 't2.h5'},
            'breakpoints.tsv', str(tmp_path / 'results.h5'),
            str(tmp_path / 'wd'), normal_id='n')
    seen = {}
    original = workflow.create_remixt_seqdata_workflow
    workflow.create_remixt_seqdata_workflow = \
        lambda *args, **kwargs: seen.update(kwargs)
    try:
        tool.create_workflow({'n': 'n.h5', 't': 't.h5'}, 'breakpoints.tsv',
                             str(tmp_path / 'results.h5'),
                             str(tmp_path / 'wd'), normal_id='n')
    finally:
        workflow.create_remixt_seqdata_workflow = original
    assert seen == {'normal_id': 'n', 'device': 'cpu'}
    assert list(wrappers.catalog) == ['remixt', 'titan', 'theta', 'clonehd']


def bp_frame(rows):
    return pd.DataFrame(rows, columns=[
        'prediction_id', 'chromosome_1', 'strand_1', 'position_1',
        'chromosome_2', 'strand_2', 'position_2'])


def bp_table(frame):
    from remixt_tpu_torch.io.table import Table
    return Table([(name, frame[name].values) for name in frame.columns])


@pytest.mark.parametrize('case', ['segalg', 'random', 'empty'])
def test_breakpoint_matching_equals_jax(case):
    """tests/test_segalg.py's case, a random one and empty sets:
    create_breakends and match_breakpoints give the JAX tables."""
    from remixt_tpu.analysis import breakpoints as jax_bp
    from remixt_tpu_torch.analysis import breakpoints as torch_bp

    if case == 'segalg':
        bp1 = bp_frame([('p1', '1', '+', 1000, '2', '-', 5000),
                        ('p2', '1', '+', 9000, '1', '-', 12000)])
        bp2 = bp_frame([('q1', '1', '+', 1100, '2', '-', 4950),
                        ('q2', '1', '+', 9100, '1', '-', 13000),
                        ('q3', '1', '-', 1000, '2', '-', 5000),
                        ('q4', '2', '-', 5000, '1', '+', 1000)])
    elif case == 'random':
        rng = np.random.RandomState(4)

        def random_bps(n, first):
            return bp_frame([
                (first + i, str(rng.randint(1, 3)), '+-'[rng.randint(2)],
                 int(rng.randint(0, 5000)), str(rng.randint(1, 3)),
                 '+-'[rng.randint(2)], int(rng.randint(0, 5000)))
                for i in range(n)])
        bp1, bp2 = random_bps(60, 0), random_bps(60, 100)
    else:
        bp1, bp2 = bp_frame([('p1', '1', '+', 1000, '2', '-', 5000)]), \
            bp_frame([])
    ends = torch_bp.create_breakends(bp_table(bp1))
    ref_ends = jax_bp.create_breakends(bp1)
    assert ends.columns == list(ref_ends.columns)
    for name in ref_ends.columns:
        assert ends[name].tolist() == ref_ends[name].tolist(), name
    got = torch_bp.match_breakpoints(bp_table(bp1), bp_table(bp2), 400)
    ref = jax_bp.match_breakpoints(bp1, bp2, search_range=400)
    assert got.columns == list(ref.columns)
    assert list(zip(*(got[c].tolist() for c in got.columns))) == \
        [tuple(r) for r in ref.itertuples(index=False)]
    if case == 'segalg':
        assert len(got) == 2


def caller_config(cs, tmp_path):
    """The external callers' config for the stand-ins of ``tmp_path/bin``
    (written there), THetA on 500 kb windows over CHROMOSOMES."""
    bin_dir = cs.write_standin_tools(str(tmp_path / 'bin'))
    segments = cs.write_window_segments(str(tmp_path / 'segments.tsv'),
                                        CHROMOSOMES, 500000)
    return bin_dir, cs.caller_config(bin_dir, segments)


def run_jax_runner(script, argv, fixture, bin_dir):
    """A JAX runner (``benchmark/<script>``) with ``argv``, the stand-ins
    first on the PATH and their truth written from the simulated germline.

    The JAX external tools' prepare tasks name no inputs, so its scheduler
    would run them before the simulation writes the seqdata they read: the
    runner runs its simulation tasks alone first, then whole, resuming
    past them (nothing is seeded between the two)."""
    import remixt_tpu.simulations.pipeline as jax_sim
    cs = chip_smoke()
    runner = load_module('jax_' + script[:-3], os.path.join(
        REPO, 'benchmark', script))
    workflow = runner.Workflow

    class SimulationOnly(workflow):
        def run(self, workdir, **kwargs):
            self.tasks = [t for t in self.tasks if t.name.startswith(
                ('simulate_', 'resample_'))]
            return super().run(workdir, **kwargs)

    saved, argv0 = jax_sim.simulate_germline_alleles, sys.argv
    jax_sim.simulate_germline_alleles = cs.with_germline_truth(
        saved, fixture['ref_data_dir'])
    try:
        with cs.first_on_path(bin_dir):
            sys.argv = [script] + argv
            for runner.Workflow in (SimulationOnly, workflow):
                runner.main()
    finally:
        sys.argv = argv0
        runner.Workflow = workflow
        jax_sim.simulate_germline_alleles = saved


def assert_same_tool_rows(merged, jax_table, tools):
    """The rows of ``tools`` in the merged evaluation's tables equal to
    those of the JAX runner's merged store ``jax_table``: strings exactly,
    floats at rtol 1e-12."""
    from remixt_tpu.io.hdf5 import HDFStore
    with HDFStore(jax_table, 'r') as store:
        for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results'):
            ref = store[name]
            ref = ref[ref['tool'].isin(tools)]
            got = merged[name]
            rows = [i for i, tool in enumerate(got['tool']) if tool in tools]
            assert got.columns == list(ref.columns), name
            assert [got['tool'][i] for i in rows] == list(ref['tool'])
            for col in ref.columns:
                values = [got[col][i] for i in rows]
                if ref[col].dtype.kind == 'f':
                    np.testing.assert_allclose(values, ref[col].values,
                                               rtol=1e-12, atol=0,
                                               err_msg=col)
                else:
                    assert [str(v) for v in values] == \
                        [str(v) for v in ref[col]], col


def assert_same_tool_runs(port_paths, jax_paths, calls, places):
    """Each external tool's files, stand-in calls, results and evaluation
    of a port run (``port_paths``: {tool: work directory, results and
    evaluation}) equal to the JAX run's: the input files byte for byte,
    the rest as ``chip_smoke.check_tool_record`` holds them."""
    cs = chip_smoke()
    for tool in cs.READ_TOOLS:
        for name in cs.TOOL_INPUTS[tool]:
            assert filecmp.cmp(
                os.path.join(port_paths[tool]['workdir'], name),
                os.path.join(jax_paths[tool]['workdir'], name),
                shallow=False), (tool, name)
        got = cs.tool_record(port_paths[tool], calls['port'], places['port'])
        want = cs.tool_record(jax_paths[tool], calls['jax'], places['jax'])
        assert len(got['calls']) == {'titan': 4, 'theta': 2,
                                     'clonehd': 5}[tool]
        cs.check_tool_record('test', tool, got, want)


def test_read_benchmark_end_to_end(fixture, tmp_path):
    """The runner's main on the CPU at test size (1 EM × 1 VI, one mix
    fraction and weight) with the four tools: simulation, the run from
    seqdata, the fit, TITAN, THetA2 and cloneHD through their stand-ins,
    the evaluations and the merge, one row per tool. The merged
    evaluation has the JAX package's columns and, on the port's results
    store, the JAX evaluation's values; the external tools' rows, files,
    stand-in calls, results and evaluations are the JAX runner's (run with
    the three tools on the same inputs); without CUDA and no device the
    runner raises."""
    import remixt_tpu.simulations.pipeline as jax_sim
    from remixt_tpu_torch.benchmark import run_read_benchmark
    from remixt_tpu_torch.io.store import read_store

    cs = chip_smoke()
    bin_dir, callers = caller_config(cs, tmp_path)
    config_file = tmp_path / 'config.yaml'
    config_file.write_text(json.dumps(dict(fixture['config'], **CONFIG,
                                           **callers)))
    raw = str(tmp_path / 'raw')
    table = str(tmp_path / 'evaluation.h5')
    argv = [fixture['ref_data_dir'], fixture['sim_defs'], raw, table,
            '--config', str(config_file)]
    import remixt_tpu_torch.simulations.pipeline as torch_sim
    original = torch_sim.simulate_germline_alleles
    torch_sim.simulate_germline_alleles = cs.with_germline_truth(
        original, fixture['ref_data_dir'])
    cs.tool_calls(bin_dir)
    try:
        with cs.first_on_path(bin_dir):
            np.random.seed(cs.RUN_NUMPY_SEED)
            run_read_benchmark.main(argv + ['--device', 'cpu', '--tools',
                                            'remixt'] + list(cs.READ_TOOLS))
    finally:
        torch_sim.simulate_germline_alleles = original
    paths = cs.read_benchmark_paths(raw)
    merged = read_store(table)
    calls = {'port': cs.tool_calls(bin_dir)}
    for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results'):
        assert merged[name]['tool'].tolist() == [
            'remixt', 'titan', 'theta', 'clonehd']

    jax_raw = str(tmp_path / 'jax_raw')
    jax_table = str(tmp_path / 'jax_runner_evaluation.h5')
    jax_config_file = tmp_path / 'jax_config.yaml'
    jax_config_file.write_text(json.dumps(dict(jax_config(fixture), **CONFIG,
                                               **callers)))
    run_jax_runner('run_read_benchmark.py', [
        fixture['ref_data_dir'], fixture['sim_defs'], jax_raw, jax_table,
        '--config', str(jax_config_file), '--tools'] + list(cs.READ_TOOLS),
        fixture, bin_dir)
    calls['jax'] = cs.tool_calls(bin_dir)
    jax_paths = cs.read_benchmark_paths(jax_raw)
    assert_same_tool_rows(merged, jax_table, cs.READ_TOOLS)
    assert_same_tool_runs(
        paths['tools'], {tool: dict(
            workdir=os.path.join(jax_paths['sim_dir'], tool),
            results=os.path.join(jax_paths['sim_dir'],
                                 'results_{}.h5'.format(tool)),
            evaluation=os.path.join(jax_paths['sim_dir'],
                                    'evaluation_{}.h5'.format(tool)))
            for tool in cs.READ_TOOLS}, calls,
        {'port': {bin_dir: '@BIN@', paths['sim_dir']: '@SIM@'},
         'jax': {bin_dir: '@BIN@', jax_paths['sim_dir']: '@SIM@'}})

    # the JAX package's own pickle of the same mixture
    jax_mixture = str(tmp_path / 'jax_mixture.pickle')
    jax_sim.simulate_genome_mixture(jax_mixture, None, sim_params(fixture))
    jax_eval = str(tmp_path / 'jax_evaluation.h5')
    jax_merged = str(tmp_path / 'jax_merged.h5')
    jax_sim.evaluate_results_task(jax_eval, paths['results'],
                                  mixture_filename=jax_mixture)
    sim_defs = jax_sim.create_simulations(
        fixture['sim_defs'], fixture['config'], fixture['ref_data_dir'])
    jax_sim.merge_evaluations(jax_merged, sim_defs,
                              {(cs.READ_SIM_ID, 'remixt'): jax_eval},
                              ['sim_id', 'tool'])
    assert_same_tool_rows(merged, jax_merged, ['remixt'])
    from remixt_tpu.io.hdf5 import HDFStore
    with HDFStore(jax_merged, 'r') as store:
        assert set(merged) >= {k.lstrip('/') for k in store.keys()
                               if not k.startswith('/brk_cn_table')}
    stats = read_store(paths['results'], keys=['stats'])['stats']
    assert np.all(np.isfinite(stats['elbo']))

    original_available = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(RuntimeError, match='CUDA'):
            run_read_benchmark.main([
                fixture['ref_data_dir'], fixture['sim_defs'],
                str(tmp_path / 'raw2'), str(tmp_path / 'e2.h5'),
                '--config', str(config_file)])
    finally:
        torch.cuda.is_available = original_available
    assert not os.path.exists(str(tmp_path / 'raw2'))


def to_the_counts(tasks):
    """A workflow's tasks without the fit, the evaluation and the merge."""
    return [t for t in tasks if '/fit_model_' not in t.name
            and not t.name.startswith(('evaluate_', 'merge_'))]


@pytest.mark.parametrize('build', ['GRCh38', 'GRCh37'])
def test_runners_give_the_jax_count_table(fixture, tmp_path, build):
    """Both packages' read benchmark runners on the fixture up to the count
    table, with nothing seeded between their tasks: the port's simulation
    tasks leave numpy's global state where the JAX tasks leave it, so the
    GC sample the run draws from it (``sample_gc``), and with it the count
    table, is the JAX package's. On either build: the run from seqdata
    phases through shapeit4's stand-ins on GRCh38 and shapeit's on
    GRCh37."""
    import remixt_tpu.simulations.pipeline as jax_sim
    import remixt_tpu_torch.simulations.pipeline as torch_sim
    from remixt_tpu_torch.benchmark import run_read_benchmark

    cs = chip_smoke()
    runner = load_module('jax_run_read_benchmark', os.path.join(
        REPO, 'benchmark', 'run_read_benchmark.py'))

    class JaxToTheCounts(runner.Workflow):
        def run(self, workdir, **kwargs):
            self.tasks = to_the_counts(self.tasks)
            return super().run(workdir, **kwargs)

    config = dict(fixture['config'], ensembl_genome_version=build)
    config_file = tmp_path / 'jax_config.yaml'
    config_file.write_text(json.dumps(jax_config(dict(fixture,
                                                      config=config))))
    raw = {name: str(tmp_path / name) for name in ('jax', 'torch')}
    saved = [(sim, sim.simulate_germline_alleles)
             for sim in (jax_sim, torch_sim)]
    argv = sys.argv
    try:
        for sim, simulate in saved:
            sim.simulate_germline_alleles = cs.with_germline_truth(
                simulate, fixture['ref_data_dir'])
        runner.Workflow = JaxToTheCounts
        with cs.first_on_path(cs.write_standin_tools(str(tmp_path / 'bin'))):
            sim_defs = torch_sim.create_simulations(
                fixture['sim_defs'], config, fixture['ref_data_dir'])
            flow = run_read_benchmark.create_workflow(
                sim_defs, raw['torch'], str(tmp_path / 'ev'), config,
                fixture['ref_data_dir'], device='cpu')
            flow.tasks = to_the_counts(flow.tasks)
            np.random.seed(1)
            flow.run(os.path.join(raw['torch'], 'work'))
            sys.argv = ['run_read_benchmark.py', fixture['ref_data_dir'],
                        fixture['sim_defs'], raw['jax'],
                        str(tmp_path / 'jax_ev.h5'), '--config',
                        str(config_file)]
            np.random.seed(2)
            runner.main()
    finally:
        sys.argv = argv
        for sim, simulate in saved:
            sim.simulate_germline_alleles = simulate

    counts = os.path.join(raw['jax'], cs.READ_SIM_ID, 'remixt', 'counts',
                          'sample_tumour.tsv')
    assert cs.count_table_digest(cs.read_benchmark_paths(raw['torch'])[
        'counts']) == cs.count_table_digest(counts)
    graphs = [name for name in ('phased.hgraph', 'phasing.bingraph')
              if any(name in files for _, _, files in os.walk(raw['torch']))]
    assert graphs == [{'GRCh38': 'phasing.bingraph',
                       'GRCh37': 'phased.hgraph'}[build]]


CHOICE_REFERENCE = dict(
    chosen=2, elbo={2: -10.0, 10: -12.0},
    proportion_divergent={2: 0.4, 10: 0.45},
    evaluation={'mix_pred_2': 0.19},
    float64=dict(chosen=2, elbo={2: -9.0, 10: -9.5},
                 proportion_divergent={2: 0.4, 10: 0.45},
                 evaluation={'mix_pred_2': 0.19}),
    perturbed=dict(chosen={1: 2, 2: 10, 3: 10},
                   elbo={1: {2: -10.0, 10: -12.0}, 2: {2: -10.0, 10: -9.0},
                         3: {2: -10.0, 10: -9.5}},
                   proportion_divergent={k: {2: 0.4, 10: 0.45}
                                         for k in (1, 2, 3)},
                   evaluation={1: {'mix_pred_2': 0.23},
                               2: {'mix_pred_2': 0.06},
                               3: {'mix_pred_2': 0.09}}))


@pytest.mark.parametrize('own, solutions, reference, passes', [
    (2, {2: 0.2}, CHOICE_REFERENCE, True),
    (2, {2: 0.24}, CHOICE_REFERENCE, True),
    (2, {2: 0.26}, CHOICE_REFERENCE, False),
    (10, {2: 0.2, 10: 0.05}, CHOICE_REFERENCE, True),
    (10, {2: 0.2, 10: 0.1}, CHOICE_REFERENCE, True),
    (10, {2: 0.26, 10: 0.05}, CHOICE_REFERENCE, False),
    (10, {2: 0.2, 10: 0.12}, CHOICE_REFERENCE, False),
    (10, {2: 0.2, 10: 0.05}, dict(CHOICE_REFERENCE, perturbed=dict(
        CHOICE_REFERENCE['perturbed'], chosen={1: 2, 2: 2, 3: 2})), False),
    (10, {2: 0.2, 10: 0.05}, {k: v for k, v in CHOICE_REFERENCE.items()
                              if k != 'perturbed'}, False),
], ids=['same choice', 'same choice within a refit\'s bars',
        'same choice outside every bar', 'a refit\'s choice',
        'a refit\'s choice within another refit\'s bars',
        'JAX choice outside every bar', 'refit choice outside every bar',
        'no JAX fit chose it', 'no perturbed refits'])
def test_check_chosen_restart(monkeypatch, own, solutions, reference,
                              passes):
    """chip_smoke's gate on a fit's chosen solution: within the bars
    (mix_pred_2's 0.02) of some JAX float32 fit that chose the same
    restart, the JAX fit or a refit from inputs moved by one ulp; where
    the choices differ, this fit's solution of the JAX choice too."""
    from types import SimpleNamespace
    import remixt_tpu_torch.analysis.pipeline as torch_pipeline
    import remixt_tpu_torch.simulations.pipeline as torch_sim

    def evaluate_tables(mixture, tables, key_prefix=''):
        init_id = (own if not key_prefix
                   else int(key_prefix.rsplit('_', 1)[1]))
        value = solutions[init_id]
        return {'mix_results': SimpleNamespace(
            to_dict=lambda: {'mix_pred_2': value})}

    monkeypatch.setattr(torch_sim, 'evaluate_tables', evaluate_tables)
    monkeypatch.setattr(torch_pipeline, 'optimal_init_id',
                        lambda stats, config: own)
    stats = {'init_id': np.array([2, 10]), 'elbo': np.array([-11.0, -10.5]),
             'proportion_divergent': np.array([0.4, 0.45])}
    check = chip_smoke().check_chosen_restart
    if passes:
        check('test', None, {'stats': stats}, reference)
    else:
        with pytest.raises((AssertionError, KeyError)):
            check('test', None, {'stats': stats}, reference)


def test_resample_runner_without_cuda_raises(fixture, tmp_path,
                                             monkeypatch):
    """No device asked for and no CUDA: the resample runner raises before
    it writes anything."""
    from remixt_tpu_torch.benchmark import run_resample_benchmark

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    raw = tmp_path / 'raw'
    with pytest.raises(RuntimeError, match='CUDA'):
        run_resample_benchmark.main([
            fixture['ref_data_dir'], fixture['sim_defs'], 'normal.h5',
            'tumour.h5', str(raw), str(tmp_path / 'table.h5'),
            '--config', fixture['config_file']])
    assert not raw.exists()


def test_resample_runner_with_the_external_tools_equals_jax(
        fixture, simulated, tmp_path):
    """Both resample runners with ``--tools titan theta clonehd`` on the
    JAX simulation's seqdata, through the shared ``add_tool_tasks``: one
    row per tool, and each tool's files, stand-in calls, results and
    evaluation the JAX runner's."""
    from remixt_tpu_torch.benchmark import run_resample_benchmark
    from remixt_tpu_torch.io.store import read_store, store_name

    cs = chip_smoke()
    bin_dir, callers = caller_config(cs, tmp_path)
    sources = simulated['jax'][0]
    raw, table, calls, places, paths = {}, {}, {}, {}, {}
    for name, config in (('port', fixture['config']),
                         ('jax', jax_config(fixture))):
        config_file = tmp_path / '{}_config.yaml'.format(name)
        config_file.write_text(json.dumps(dict(config, **callers)))
        raw[name] = str(tmp_path / '{}_raw'.format(name))
        table[name] = str(tmp_path / '{}_evaluation.h5'.format(name))
        argv = [fixture['ref_data_dir'], fixture['sim_defs'],
                sources['normal'], sources['tumour'], raw[name],
                table[name], '--config', str(config_file),
                '--tools'] + list(cs.READ_TOOLS)
        cs.tool_calls(bin_dir)
        if name == 'port':
            with cs.first_on_path(bin_dir):
                run_resample_benchmark.main(argv + ['--device', 'cpu'])
        else:
            run_jax_runner('run_resample_benchmark.py', argv, fixture,
                           bin_dir)
        calls[name] = cs.tool_calls(bin_dir)
        sim_dir = os.path.join(raw[name], cs.READ_SIM_ID)
        places[name] = {bin_dir: '@BIN@', sim_dir: '@SIM@'}
        suffix = store_name if name == 'port' else (lambda stem:
                                                    stem + '.h5')
        paths[name] = {tool: dict(
            workdir=os.path.join(sim_dir, tool),
            results=suffix(os.path.join(sim_dir, tool, 'results')),
            evaluation=suffix(os.path.join(sim_dir, tool, 'evaluation')))
            for tool in cs.READ_TOOLS}
    merged = read_store(table['port'])
    for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results'):
        assert merged[name]['tool'].tolist() == list(cs.READ_TOOLS)
    assert_same_tool_rows(merged, table['jax'], cs.READ_TOOLS)
    assert_same_tool_runs(paths['port'], paths['jax'], calls, places)


# ---------------------------------------------------------------------------
# phase 12's reference numbers
# ---------------------------------------------------------------------------

def jax_tool_records(cs, sim_dir, calls, bin_dir):
    """``chip_smoke.tool_record`` of each external tool of a JAX read
    benchmark run in ``sim_dir``."""
    return {tool: cs.tool_record(
        dict(workdir=os.path.join(sim_dir, tool),
             results=os.path.join(sim_dir, 'results_{}.h5'.format(tool)),
             evaluation=os.path.join(sim_dir,
                                     'evaluation_{}.h5'.format(tool))),
        calls, {bin_dir: '@BIN@', sim_dir: '@SIM@'})
        for tool in cs.READ_TOOLS}


def phase12_reference(workdir, build, tools_only=False):
    """Run the JAX package's read benchmark on phase 12's inputs, on the
    genome build ``build``, with ReMixT and the external callers (through
    the stand-ins; THetA on ``READ_THETA_WINDOW`` windows), and the port's
    up to the count table; print the constants of ``READ_JAX``. With
    ``tools_only``, run the JAX benchmark with the external callers alone,
    check its seqdata against ``READ_JAX``'s and print its ``tools``."""
    from remixt_tpu.io.hdf5 import HDFStore
    import remixt_tpu_torch.simulations.pipeline as torch_sim
    from remixt_tpu_torch.benchmark import run_read_benchmark

    cs = chip_smoke()
    t0 = time.time()
    fixture = cs.make_read_fixture(os.path.join(workdir, 'fixture'),
                                   cs.RUN_CHROMOSOMES, cs.READ_H_TOTAL,
                                   with_hdf5=True, genome_version=build)
    print('fixture', build, fixture['times'], round(time.time() - t0, 1),
          flush=True)
    bin_dir = cs.write_standin_tools(os.path.join(workdir, 'bin'))
    segments = cs.write_window_segments(
        os.path.join(workdir, 'fixture', 'theta_segments.tsv'),
        cs.RUN_CHROMOSOMES, cs.READ_THETA_WINDOW)
    config_file = os.path.join(workdir, 'jax_config.yaml')
    with open(config_file, 'w') as f:
        json.dump(dict(jax_config(fixture),
                       **cs.caller_config(bin_dir, segments)), f)

    raw = {'jax': os.path.join(workdir, 'jax'),
           'torch': os.path.join(workdir, 'torch')}
    for path in raw.values():
        shutil.rmtree(path, ignore_errors=True)
    saved = torch_sim.simulate_germline_alleles
    torch_sim.simulate_germline_alleles = cs.with_germline_truth(
        saved, fixture['ref_data_dir'])
    try:
        with cs.first_on_path(bin_dir):
            sim_defs = torch_sim.create_simulations(
                fixture['sim_defs'], fixture['config'],
                fixture['ref_data_dir'])
            flow = run_read_benchmark.create_workflow(
                sim_defs, raw['torch'], os.path.join(raw['torch'], 'ev'),
                fixture['config'], fixture['ref_data_dir'], device='cpu')
            flow.tasks = [t for t in flow.tasks
                          if '/fit_model_' not in t.name
                          and not t.name.startswith(('evaluate_', 'merge_'))]
            t0 = time.time()
            if not tools_only:
                flow.run(os.path.join(raw['torch'], 'work'))
                print('port run to the counts', round(time.time() - t0, 1),
                      flush=True)
    finally:
        torch_sim.simulate_germline_alleles = saved

    cs.tool_calls(bin_dir)
    t0 = time.time()
    run_jax_runner('run_read_benchmark.py', [
        fixture['ref_data_dir'], fixture['sim_defs'], raw['jax'],
        os.path.join(raw['jax'], 'evaluation.h5'), '--config', config_file,
        '--tools'] + ([] if tools_only else ['remixt']) + list(
            cs.READ_TOOLS), fixture, bin_dir)
    print('jax read benchmark', round(time.time() - t0, 1), flush=True)

    sim_dir = os.path.join(raw['jax'], cs.READ_SIM_ID)
    tools = jax_tool_records(cs, sim_dir, cs.tool_calls(bin_dir), bin_dir)
    if tools_only:
        for sample in ('normal', 'tumour'):
            assert cs.seqdata_digest(os.path.join(
                sim_dir, sample + '.h5')) == cs.READ_JAX['seqdata'][sample]
        print('seqdata equal to READ_JAX\'s', flush=True)
        print('READ_JAX.update(tools=' + repr(tools) + ')')
        return
    port = cs.read_benchmark_paths(raw['torch'])
    seqdata = {}
    for sample in ('normal', 'tumour'):
        seqdata[sample] = cs.seqdata_digest(
            os.path.join(sim_dir, sample + '.h5'))
        assert cs.seqdata_digest(port['seqdata'][sample]) == \
            seqdata[sample], sample
    print('seqdata equal', flush=True)
    counts = cs.count_table_digest(os.path.join(
        sim_dir, 'remixt', 'counts', 'sample_tumour.tsv'))
    assert cs.count_table_digest(port['counts']) == counts
    print('count tables equal', flush=True)
    with HDFStore(os.path.join(sim_dir, 'evaluation_remixt.h5'),
                  'r') as store:
        metrics = {}
        for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results'):
            metrics.update({k: float(v) for k, v in store[name].items()})
    print('READ_JAX = ' + repr(dict(
        seqdata=seqdata, counts=counts, segments=counts['rows'],
        evaluation=metrics, **reference_run().jax_fit_choice(
            os.path.join(sim_dir, 'results_remixt.h5')),
        **phase12_near(workdir), tools=tools)))


def reference_run():
    return load_module('test_torch_run', os.path.join(
        REPO, 'tests', 'test_torch_run.py'))


def phase12_near(workdir):
    """``test_torch_run.jax_near_references`` on the JAX benchmark of a
    finished ``--phase12`` WORKDIR."""
    sim_dir = os.path.join(workdir, 'jax', chip_smoke().READ_SIM_ID)
    with open(os.path.join(sim_dir, 'mixture.pickle'), 'rb') as f:
        mixture = pickle.load(f)
    return reference_run().jax_near_references(
        os.path.join(sim_dir, 'remixt', 'experiment', 'sample_tumour.pickle'),
        os.path.join(sim_dir, 'results_remixt.h5'), mixture,
        os.path.join(workdir, 'near'))


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser(
        usage='python tests/test_torch_read_benchmark.py --phase12 WORKDIR '
              '[--near | --tools] [--build GRCh37|GRCh38]')
    parser.add_argument('--phase12', metavar='WORKDIR', required=True)
    parser.add_argument('--near', action='store_true')
    parser.add_argument('--tools', action='store_true',
                        help='run the JAX benchmark with the external '
                             'callers alone and print READ_JAX\'s tools')
    parser.add_argument('--build', choices=['GRCh37', 'GRCh38'],
                        help='the reference\'s genome build (default: '
                             'chip_smoke.READ_GENOME_VERSION)')
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    if args.near:
        print('READ_JAX.update(' + repr(phase12_near(args.phase12)) + ')')
    else:
        phase12_reference(args.phase12, args.build
                          or chip_smoke().READ_GENOME_VERSION, args.tools)
