"""The port's results CLI (``write_results``, ``visualize_solutions``)
against the JAX package's, on a results store that the port's fit wrote.

The fit is ``tests/test_cli.py``'s (max copy number 6) on 11 chromosomes
of 4 segments ('1' to '11', so that '10' sorts after '9'), on the CPU
at 1 EM × 2 VI over a grid of two mix fractions and two divergence
weights, written once as HDF5 and once as a directory of TSV tables. On
the same store the port's cn and brk_cn TSVs are byte-equal to the JAX
``write_results_tables``' and its metadata YAML loads to the same dict;
the report's HTML, its JSON payload included, is byte-equal to the JAX
``create_solutions_visualization``'s. Tolerance 0 throughout. Also
``tests/test_cli.py``'s assertions, on the port's CLI and scheduler.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import remixt_tpu.ui.write_results as jax_write_results
import remixt_tpu.visualize as jax_visualize
from remixt_tpu.io.hdf5 import HDFStore
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch import visualize as torch_visualize
from remixt_tpu_torch.io.store import read_store
from remixt_tpu_torch.scheduler import Workflow
from remixt_tpu_torch.ui import main as torch_main
from remixt_tpu_torch.ui import write_results as torch_write_results

from test_cli import _write_tables

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

FORMS = ['h5', 'dir']
CONFIG = {
    'max_copy_number': 6,
    'num_em_iter': 1,
    'num_update_iter': 2,
    'likelihood_min_segment_length': 1.0,
    'divergence_weights': [1e-7, 1e-6],
    'tumour_mix_fractions': [0.4, 0.2],
    'min_ploidy': 1.0,
    'max_ploidy': 8.0,
    'h_normal': 0.08,
    'h_tumour': 0.075,
}


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    """{form: results store} of the port's fit CLI on the CPU."""
    import remixt_tpu_torch.ui.fit

    tmp = tmp_path_factory.mktemp('results_cli')
    data = sim.simulate_experiment(
        N=44, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
        negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=7,
        num_chains=11)
    count_file, breakpoint_file = _write_tables(tmp, data)
    config_file = str(tmp / 'config.yaml')
    with open(config_file, 'w') as f:
        yaml.dump(CONFIG, f)
    stores = {'h5': str(tmp / 'results.h5'), 'dir': str(tmp / 'results')}
    for form, path in stores.items():
        remixt_tpu_torch.ui.fit.fit(
            count_file, breakpoint_file, path, str(tmp / ('work_' + form)),
            config=config_file, min_length=None, device='cpu')
    return dict(tmp=tmp, stores=stores)


def write_results(module, results_file, out_dir, **filters):
    os.makedirs(out_dir, exist_ok=True)
    names = {key: os.path.join(out_dir, key.split('_')[0] + ext)
             for key, ext in (('cn_filename', '.tsv'),
                              ('brk_cn_filename', '_brk.tsv'),
                              ('meta_filename', '.yaml'))}
    args = dict(max_ploidy=None, min_ploidy=None,
                max_proportion_divergent=0.5)
    args.update(filters)
    module.write_results_tables(results_filename=results_file, **names,
                                **args)
    return names


def read_bytes(path):
    with open(path, 'rb') as f:
        return f.read()


@pytest.mark.parametrize('form', FORMS)
def test_write_results_equals_jax(results, form):
    tmp = results['tmp']
    ref = write_results(jax_write_results, results['stores']['h5'],
                        str(tmp / 'jax_out'))
    got = write_results(torch_write_results, results['stores'][form],
                        str(tmp / ('torch_out_' + form)))
    for key in ('cn_filename', 'brk_cn_filename'):
        assert read_bytes(got[key]) == read_bytes(ref[key]), key
    with open(got['meta_filename']) as f:
        got_meta = yaml.safe_load(f)
    with open(ref['meta_filename']) as f:
        ref_meta = yaml.safe_load(f)
    assert got_meta == ref_meta
    assert isinstance(got_meta['h'], list) and len(got_meta['mix']) == 3


def test_filters_choose_as_jax_does():
    """The divergence and ploidy filters pick the JAX package's solution
    (on a tie, the first row; a NaN ELBO never), and raise ValueError
    where no solution passes."""
    import pandas as pd
    from remixt_tpu_torch.io.table import Table

    rng = np.random.RandomState(9)
    columns = {
        'init_id': np.arange(10),
        'elbo': np.round(rng.uniform(-100., -90., 10)),
        'ploidy': rng.uniform(1., 6., 10),
        'proportion_divergent': rng.uniform(0., 1., 10),
    }
    columns['elbo'][[2, 7]] = columns['elbo'].max() + 1.0
    columns['elbo'][4] = np.nan
    stats, jax_stats = Table(columns), pd.DataFrame(columns)
    chosen = set()
    for max_divergent in (1.0, 0.5, 0.3):
        for min_ploidy in (None, 2.0, 3.5):
            for max_ploidy in (None, 5.0, 4.0):
                try:
                    ref = jax_write_results._select_solution(
                        jax_stats, max_divergent, min_ploidy, max_ploidy)
                except ValueError:
                    with pytest.raises(ValueError, match='no solutions'):
                        torch_write_results.select_solution(
                            stats, max_divergent, min_ploidy, max_ploidy)
                    chosen.add(None)
                    continue
                row = torch_write_results.select_solution(
                    stats, max_divergent, min_ploidy, max_ploidy)
                assert stats['init_id'][row] == ref['init_id']
                chosen.add(int(ref['init_id']))
    assert len(chosen) > 3 and None in chosen and 2 in chosen


@pytest.mark.parametrize('form', FORMS)
def test_visualize_solutions_equals_jax(results, form):
    """The report, its embedded JSON payload included, byte for byte; the
    payload carries the solutions, the read-depth densities and every
    restart's statistics."""
    import json

    tmp = results['tmp']
    ref = str(tmp / 'jax.html')
    got = str(tmp / 'torch_{}.html'.format(form))
    jax_visualize.create_solutions_visualization(results['stores']['h5'],
                                                 ref)
    torch_main.main(['visualize_solutions', results['stores'][form], got])
    assert read_bytes(got) == read_bytes(ref)
    html = read_bytes(got).decode()
    data = json.loads(html.split('const DATA = ', 1)[1].split(';\n', 1)[0])
    assert len(data['solutions']) == len(data['stats']) == 4
    assert data['best'] in data['solutions']
    assert len(data['read_depth']['x']) == 502
    marks = data['solutions'][data['best']]['chrom_marks']
    assert [m['name'] for m in marks] == [str(c) for c in range(1, 12)]


def test_create_genome_visualization_equals_jax(results):
    tmp = results['tmp']
    with HDFStore(results['stores']['h5'], 'r') as store:
        cn, brk_cn = store['/cn'], store['/brk_cn']
    tables = read_store(results['stores']['dir'], keys=['cn', 'brk_cn'])
    stats = [{'a': 1, 'b': 0.5}]
    jax_visualize.create_genome_visualization(cn, brk_cn,
                                              str(tmp / 'jax_genome.html'),
                                              stats=stats)
    torch_visualize.create_genome_visualization(
        tables['cn'], tables['brk_cn'], str(tmp / 'torch_genome.html'),
        stats=stats)
    assert read_bytes(tmp / 'torch_genome.html') == \
        read_bytes(tmp / 'jax_genome.html')


def test_main_registers_the_results_subcommands(capsys):
    with pytest.raises(SystemExit) as exit_info:
        torch_main.main(['--help'])
    assert exit_info.value.code == 0
    assert ('{fit,run,write_results,visualize_solutions,create_ref_data,'
            'mappability_bwa}') in capsys.readouterr().out
    for name in ('write_results', 'visualize_solutions'):
        with pytest.raises(SystemExit):
            torch_main.main([name, '--help'])
        assert 'results' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# tests/test_cli.py's assertions on the port
# ---------------------------------------------------------------------------

def test_fit_cli_results_exist(results):
    for path in results['stores'].values():
        assert os.path.exists(path)


def test_write_results_cli(results):
    tmp = results['tmp']
    torch_main.main(['write_results', results['stores']['dir'],
                     str(tmp / 'cli_cn.tsv'), str(tmp / 'cli_brk_cn.tsv'),
                     str(tmp / 'cli_meta.yaml')])
    with open(tmp / 'cli_cn.tsv') as f:
        assert 'major_1' in f.readline().split('\t')
    with open(tmp / 'cli_meta.yaml') as f:
        meta = yaml.safe_load(f)
    assert 'elbo' in meta
    assert len(meta['mix']) == 3


def test_visualize_solutions_cli(results):
    import remixt_tpu_torch.ui.visualize_solutions
    html_file = str(results['tmp'] / 'solutions.html')
    remixt_tpu_torch.ui.visualize_solutions.create_visualization(
        results=results['stores']['h5'], html=html_file)
    with open(html_file) as f:
        html = f.read()
    assert 'remixt-tpu solutions' in html
    assert 'major_raw' in html
    assert '"read_depth": {' in html
    assert '"minor_modes"' in html


def test_main_parser():
    assert hasattr(torch_main, 'main')


def _write_file(path, content):
    with open(path, 'w') as f:
        f.write(content)


def _concat_files(out, *ins):
    with open(out, 'w') as f:
        for i in ins:
            with open(i) as g:
                f.write(g.read())


def _read(path):
    with open(path) as f:
        return f.read()


def test_scheduler_dag_and_resume(tmp_path):
    a, b, c = (str(tmp_path / name) for name in ('a.txt', 'b.txt', 'c.txt'))

    def build():
        wf = Workflow('test')
        wf.transform('write_a', _write_file, args=(a, 'A'), outputs=[a])
        wf.transform('write_b', _write_file, args=(b, 'B'), outputs=[b])
        wf.transform('concat', _concat_files, args=(c, a, b),
                     inputs=[a, b], outputs=[c])
        return wf

    workdir = str(tmp_path / 'work')
    build().run(workdir)
    assert _read(c) == 'AB'

    # completed tasks are skipped: a tampered output stays
    _write_file(c, 'TAMPERED')
    build().run(workdir)
    assert _read(c) == 'TAMPERED'

    # touching an input forces the downstream task to rerun
    import time
    time.sleep(0.01)
    _write_file(a, 'A2')
    build().run(workdir)
    assert _read(c) == 'A2B'


def test_scheduler_ret_values(tmp_path):
    def produce():
        return {'x': 41}

    def consume(out, value):
        _write_file(out, str(value + 1))

    out = str(tmp_path / 'out.txt')
    wf = Workflow('retvals')
    ret = wf.transform('produce', produce)
    wf.transform('consume', consume, args=(out, ret['x']), outputs=[out])
    wf.run(str(tmp_path / 'work'))
    assert _read(out) == '42'


def test_scheduler_missing_ret_reruns(tmp_path):
    """A surviving sentinel whose return pickle is gone does not resume as
    completed."""
    out = str(tmp_path / 'out.txt')

    def produce():
        return {'x': 41}

    def consume(filename, value):
        _write_file(filename, str(value + 1))

    def build():
        wf = Workflow('retloss')
        ret = wf.transform('produce', produce)
        wf.transform('consume', consume, args=(out, ret['x']), outputs=[out])
        return wf

    workdir = str(tmp_path / 'work')
    build().run(workdir)
    assert _read(out) == '42'

    os.remove(os.path.join(workdir, '.ret_produce.pickle'))
    os.remove(out)
    build().run(workdir)
    assert _read(out) == '42'
