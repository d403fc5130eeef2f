"""The port's external-tool wrappers (``remixt_tpu_torch/wrappers``:
``formats``, ``wraptitan``, ``wraptheta``, ``wrapclonehd``,
``wrapexternal``) against the JAX package's, on the CPU.

The seqdata are made from a seed with numpy (two chromosomes of 2 and
1.5 Mb, the tumour's depth and allele balance changing every 250 kb) and
written by both packages' writers: the JAX package's HDF5 file, the
port's HDF5 file and the port's directory of ``.npy`` chunks. Every file a
wrapper writes for a tool must be byte-equal to the JAX wrapper's on the
same seqdata; every parser must give the JAX table (ints and strings
exactly, floats at rtol 1e-12); the tools run as ``chip_smoke.py``'s
stand-ins (``write_standin_tools``), whose call logs must be equal; each
tool's workflow must run through the scheduler to a results store and an
evaluation equal to the JAX package's. tests/test_wrappers.py's nine
cases are each held here too.
"""

import filecmp
import importlib.util
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

import remixt_tpu.seqdataio as jax_seqdataio
import remixt_tpu.simulations.pipeline as jax_sim
from remixt_tpu.io.hdf5 import HDFStore as JaxStore
from remixt_tpu.wrappers import formats as jax_formats
from remixt_tpu.wrappers import wrapclonehd as jax_clonehd
from remixt_tpu.wrappers import wrapexternal as jax_external
from remixt_tpu.wrappers import wraptheta as jax_theta
from remixt_tpu.wrappers import wraptitan as jax_titan
from remixt_tpu_torch import seqdataio
from remixt_tpu_torch.io.store import read_store
from remixt_tpu_torch.io.table import Table, read_tsv
from remixt_tpu_torch.simulations import pipeline as torch_sim
from remixt_tpu_torch.wrappers import formats, wrapclonehd, wrapexternal
from remixt_tpu_torch.wrappers import wraptheta, wraptitan

from test_torch_simulations import PARAMS

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHROMOSOMES = {'1': 2000000, '2': 1500000}
SEED = 19
BLOCK = 250000
SNP_SPACING = 1000
READS_PER_SNP = 12
# the stores the port's wrappers read: the JAX package's HDF5 file, the
# port's HDF5 file and the port's directory
STORE_KINDS = ['jax_h5', 'torch_h5', 'torch_dir']
TOOLS = ['titan', 'theta', 'clonehd']
TOOL_CLASSES = {'titan': 'TitanTool', 'theta': 'ThetaTool',
                'clonehd': 'CloneHDTool'}
# THetA's segmentation: fixed windows over CHROMOSOMES
THETA_WINDOW = 500000
RTOL = 1e-12


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sample_tables(rng, depth, tumour):
    """{chromosome: (fragments, alleles)} column dicts of one sample: 150
    bp fragments at ``depth`` a 100 bp, times a multiplier drawn per 250
    kb block in the tumour; SNPs every kb, the even ones het, with 12
    reads each whose alt share is a half, or one drawn per block in the
    tumour."""
    tables = {}
    for chromosome, length in CHROMOSOMES.items():
        blocks = -(-length // BLOCK)
        scale = (rng.choice([0.5, 1.0, 1.5, 2.0], size=blocks) if tumour
                 else np.ones(blocks))
        alt_share = (rng.choice([0.2, 0.5, 0.8], size=blocks) if tumour
                     else np.full(blocks, 0.5))
        starts = np.sort(np.concatenate([
            rng.randint(b * BLOCK, min((b + 1) * BLOCK, length) - 200,
                        size=int(depth * scale[b] * BLOCK / 100))
            for b in range(blocks)]))
        fragments = dict(fragment_id=np.arange(len(starts)), start=starts,
                         end=starts + 150)
        positions = np.arange(500, length, SNP_SPACING)
        het = np.arange(len(positions)) % 2 == 0
        share = np.where(het, alt_share[positions // BLOCK], 0.)
        reads = np.repeat(np.arange(len(positions)), READS_PER_SNP)
        alleles = dict(
            fragment_id=rng.randint(len(starts), size=len(reads)),
            position=positions[reads],
            is_alt=(rng.rand(len(reads)) < share[reads]).astype(np.int64))
        tables[chromosome] = (fragments, alleles)
    return tables


@pytest.fixture(scope='module')
def seqdata(tmp_path_factory):
    """{kind: {'normal': path, 'tumour': path}} for each of STORE_KINDS,
    the same tables in each, plus 'root'."""
    root = tmp_path_factory.mktemp('wrappers')
    rng = np.random.RandomState(SEED)
    samples = {'normal': sample_tables(rng, 1.0, False),
               'tumour': sample_tables(rng, 1.5, True)}
    out = {'root': root}
    for kind in STORE_KINDS:
        out[kind] = {}
        for sample, tables in samples.items():
            path = str(root / '{}_{}{}'.format(
                kind, sample, '' if kind == 'torch_dir' else '.h5'))
            if kind == 'jax_h5':
                writer = jax_seqdataio.Writer(path)
                for chromosome, (fragments, alleles) in tables.items():
                    writer.write(chromosome, pd.DataFrame(fragments),
                                 pd.DataFrame(alleles))
            else:
                writer = seqdataio.Writer(path)
                for chromosome, (fragments, alleles) in tables.items():
                    writer.write(chromosome, Table(fragments),
                                 Table(alleles))
            writer.close()
            out[kind][sample] = path
    return out


def as_table(frame):
    return Table([(name, frame[name].values) for name in frame.columns])


def assert_same_table(got, ref, index=False):
    """A port Table against a pandas DataFrame: the same columns in the
    same order, ints and strings exactly, floats at RTOL."""
    assert got.columns == [str(c) for c in ref.columns]
    assert len(got) == len(ref.index)
    for name in ref.columns:
        want = ref[name].values
        if want.dtype.kind == 'f':
            np.testing.assert_allclose(np.asarray(got[str(name)], float),
                                       want, rtol=RTOL, atol=0,
                                       err_msg=str(name))
        else:
            assert [str(v) for v in got[str(name)]] == \
                [str(v) for v in want], name
    if index:
        assert got.index.tolist() == ref.index.tolist()


def assert_same_files(got, ref):
    for name in ref:
        if name != 'chrom_idx':
            assert filecmp.cmp(got[name], ref[name], shallow=False), name


def windows():
    rows = [(c, s, min(s + THETA_WINDOW, n)) for c, n in CHROMOSOMES.items()
            for s in range(0, n, THETA_WINDOW)]
    return pd.DataFrame(rows, columns=['chromosome', 'start', 'end'])


# ---------------------------------------------------------------------------
# the input views and writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', STORE_KINDS)
def test_binned_read_counts(seqdata, kind):
    """tests/test_wrappers.py's case: a bin a kb up to each length, in the
    JAX package's chromosome order, the JAX counts."""
    ref = list(jax_formats.binned_read_counts(
        seqdata['jax_h5']['normal'], CHROMOSOMES, bin_size=1000))
    got = list(formats.binned_read_counts(
        seqdata[kind]['normal'], CHROMOSOMES, bin_size=1000))
    assert [c for c, _ in got] == [c for c, _ in ref]
    for (_, counts), (_, want) in zip(got, ref):
        np.testing.assert_array_equal(counts, want)
    binned = dict(got)
    assert len(binned['1']) == 2000 and len(binned['2']) == 1500
    assert sum(binned['1']) > 0


@pytest.mark.parametrize('kind', STORE_KINDS)
def test_het_tumour_allele_counts(seqdata, kind):
    """tests/test_wrappers.py's case: only the even (het) SNPs survive the
    normal's genotype call; the JAX table."""
    ref = jax_formats.het_tumour_allele_counts(
        seqdata['jax_h5']['normal'], seqdata['jax_h5']['tumour'])
    got = formats.het_tumour_allele_counts(
        seqdata[kind]['normal'], seqdata[kind]['tumour'])
    assert len(got) > 0
    assert (got['position'] % 2000 == 500).all()
    assert_same_table(got, ref)


def test_het_tumour_allele_counts_of_no_chromosome(tmp_path):
    """A normal store without a chromosome gives an empty table with the
    four columns, as the JAX function's."""
    empty = str(tmp_path / 'empty.h5')
    jax_seqdataio.Writer(empty).close()
    ref = jax_formats.het_tumour_allele_counts(empty, empty)
    got = formats.het_tumour_allele_counts(empty, empty)
    assert len(got) == 0 and got.columns == list(ref.columns)


@pytest.mark.parametrize('kind', STORE_KINDS)
@pytest.mark.parametrize('tool', TOOLS)
def test_tool_inputs_are_the_jax_files(seqdata, tmp_path, tool, kind):
    """Every file a wrapper writes for its tool is byte-equal to the JAX
    wrapper's on the same seqdata."""
    jax_stores, stores = seqdata['jax_h5'], seqdata[kind]
    if tool == 'theta':
        ref = jax_theta.prepare_inputs(
            str(tmp_path / 'jax'), jax_stores['normal'],
            jax_stores['tumour'], windows())
        got = wraptheta.prepare_inputs(
            str(tmp_path / 'port'), stores['normal'], stores['tumour'],
            as_table(windows()))
        assert got['chrom_idx'] == ref['chrom_idx']
    else:
        jax_module, module = {'titan': (jax_titan, wraptitan),
                              'clonehd': (jax_clonehd, wrapclonehd)}[tool]
        ref = jax_module.prepare_inputs(
            str(tmp_path / 'jax'), jax_stores['normal'],
            jax_stores['tumour'], CHROMOSOMES)
        got = module.prepare_inputs(
            str(tmp_path / 'port'), stores['normal'], stores['tumour'],
            CHROMOSOMES)
    assert list(got) == list(ref)
    assert_same_files(got, ref)


def test_titan_inputs_and_conversion(seqdata, tmp_path):
    """tests/test_wrappers.py's case: the WIG headers, the allele table,
    and the report of two synthetic restarts (the second better) byte-equal
    to the JAX report."""
    stores = seqdata['torch_dir']
    paths = wraptitan.prepare_inputs(
        str(tmp_path / 'titan'), stores['normal'], stores['tumour'],
        CHROMOSOMES)
    wig = open(paths['tumour_wig']).read().splitlines()
    headers = [line for line in wig if line.startswith('fixedStep')]
    assert sorted(headers) == [
        'fixedStep chrom=1 start=1 step=1000 span=1000',
        'fixedStep chrom=2 start=1 step=1000 span=1000']
    assert len(open(paths['alleles']).read().splitlines()) > 0

    for idx, (sdbw, prev) in enumerate([(0.5, '0.8'), (0.2, '0.9 0.4')]):
        d = tmp_path / 'titan' / 'restart_{}'.format(idx)
        os.makedirs(d, exist_ok=True)
        with open(d / 'params.txt', 'w') as f:
            f.write('Normal contamination estimate: 0.4\n')
            f.write('S_Dbw validity index: {}\n'.format(sdbw))
            f.write('Clonal cluster cellular prevalence Z={}: {}\n'.format(
                idx + 1, prev))
        pd.DataFrame({
            'Chromosome': ['1', '1'],
            'Start_Position(bp)': [0, 10000],
            'End_Position(bp)': [10000, 20000],
            'Copy_Number': [2, 3],
            'MajorCN': [1, 2],
            'MinorCN': [1, 1],
            'Clonal_Cluster': [1, 2],
        }).to_csv(d / 'cn.tsv', sep='\t', index=False)
    restart_dirs = {i: str(tmp_path / 'titan' / 'restart_{}'.format(i))
                    for i in (0, 1)}
    outputs = {}
    for name, module in (('jax', jax_titan), ('port', wraptitan)):
        outputs[name] = [str(tmp_path / '{}_{}.tsv'.format(name, kind))
                         for kind in ('cn', 'mix')]
        module.report(restart_dirs, *outputs[name], {0: 1, 1: 2})
    for got, ref in zip(outputs['port'], outputs['jax']):
        assert filecmp.cmp(got, ref, shallow=False)
    mix = [float(v) for v in open(outputs['port'][1]).read().split()]
    np.testing.assert_allclose(mix, [0.4, 0.6 * 0.4, 0.6 * 0.5])
    cn = read_tsv(outputs['port'][0], str_columns=('chromosome',))
    assert cn['major_2'][0] == 1 and cn['total_2'][0] == 2
    assert cn['total_1'][1] == 3 and cn['total_2'][1] == 2


def theta_results(path, rows):
    with open(path, 'w') as f:
        f.write('#NLL\tmu\tC\tp*\tBAF_NLL\n')
        f.writelines('\t'.join(row) + '\n' for row in rows)


def test_theta_inputs_and_conversion(seqdata, tmp_path):
    """tests/test_wrappers.py's case: three intervals, the lower total NLL
    row chosen; the report byte-equal to the JAX report."""
    segments = pd.DataFrame({'chromosome': ['1', '1', '2'],
                             'start': [0, 10000, 0],
                             'end': [10000, 20000, 10000]})
    stores = seqdata['torch_h5']
    paths = wraptheta.prepare_inputs(
        str(tmp_path / 'theta'), stores['normal'], stores['tumour'],
        as_table(segments))
    counts = read_tsv(paths['counts'], names=wraptheta.INTERVAL_COLUMNS)
    assert len(counts) == 3 and (counts['count_tumour'] > 0).all()
    theta_results(tmp_path / 'theta' / 'theta2.BAF.NLL.results', [
        ('100.', '0.4,0.35,0.25', '2,1:3,2:2,2', '-', '30.'),
        ('90.', '0.5,0.3,0.2', '2,2:3,1:1,1', '-', '20.')])
    chrom_names = {v: k for k, v in paths['chrom_idx'].items()}
    outputs = {}
    for name, module in (('jax', jax_theta), ('port', wraptheta)):
        outputs[name] = [str(tmp_path / '{}_{}.tsv'.format(name, kind))
                         for kind in ('cn', 'mix')]
        module.report(str(tmp_path / 'theta'), *outputs[name], chrom_names)
    for got, ref in zip(outputs['port'], outputs['jax']):
        assert filecmp.cmp(got, ref, shallow=False)
    cn = read_tsv(outputs['port'][0], str_columns=('chromosome',))
    assert cn['total_1'].tolist() == [2, 3, 1]
    assert cn['total_2'].tolist() == [2, 1, 1]
    assert cn['chromosome'].tolist() == ['1', '1', '2']


def test_theta_allele_file_has_nine_columns(seqdata, tmp_path):
    """tests/test_wrappers.py's case: chrom_idx, position, A, C, T, G,
    total, ref, alt; the nucleotide columns zero, total = ref + alt."""
    segments = Table([('chromosome', np.array(['1', '2'], dtype=object)),
                      ('start', np.array([0, 0])),
                      ('end', np.array([2000000, 1500000]))])
    stores = seqdata['torch_dir']
    paths = wraptheta.prepare_inputs(
        str(tmp_path / 'theta'), stores['normal'], stores['tumour'],
        segments)
    table = pd.read_csv(paths['tumour_alleles'], sep='\t', header=None)
    assert table.shape[1] == 9
    assert (table[[2, 3, 4, 5]] == 0).all().all()
    np.testing.assert_array_equal(table[6].values,
                                  (table[7] + table[8]).values)


def posterior(path, rows, states, sep=' '):
    columns = ['#chr', 'first-locus', 'last-locus', 'nloci'] + [
        str(i) for i in range(states)]
    pd.DataFrame(rows, columns=columns).to_csv(path, sep=sep, index=False,
                                               na_rep='nan')


def test_clonehd_baf_loci_not_shifted(tmp_path):
    """tests/test_wrappers.py's case: CNA loci are bin ends (shifted one
    bin left), BAF loci SNP positions (not shifted)."""
    path = str(tmp_path / 'posterior.txt')
    posterior(path, [['1', 1000, 10000, 10, 0.2, 0.8]], 2)
    for bin_size, start in ((1000, 0), (None, 1000)):
        got = wrapclonehd._argmax_calls(path, bin_size=bin_size)
        assert_same_table(got, jax_clonehd._argmax_calls(
            path, bin_size=bin_size))
        assert got['start'][0] == start and got['call'][0] == 1


def test_external_workflow_tasks_are_picklable(tmp_path, monkeypatch):
    """tests/test_wrappers.py's case: the scheduler's spawn pool pickles
    the tasks; every stage of every external tool survives it."""
    monkeypatch.setattr(wrapexternal.ExternalTool, 'chromosome_lengths',
                        lambda self: dict(CHROMOSOMES))
    config = {
        'titan': {'run_script': 'titan_run.R'},
        'theta': {'bin': 'RunTHetA', 'octave_bin_directory': 'theta/matlab',
                  'segments_filename': str(tmp_path / 'segments.tsv')},
        'clonehd': {},
    }
    for name in TOOLS:
        tool = getattr(wrapexternal, TOOL_CLASSES[name])(
            config, str(tmp_path), device='cpu')
        workflow = wrapexternal.Workflow('{}_pickle'.format(tool.name))
        tool._add_stages(workflow, 'normal', 'tumour',
                         str(tmp_path / 'results'), str(tmp_path / 'wd'))
        assert [t.name for t in workflow.tasks] == [
            'prepare', 'run', 'report']
        for task in workflow.tasks:
            func, args, kwargs = pickle.loads(pickle.dumps(
                (task.func, task.args, task.kwargs)))
            assert func is task.func and args == task.args


def test_remixt_wrapper_rejects_multiple_tumours(tmp_path, monkeypatch):
    """tests/test_wrappers.py's case, for the port's ReMixT wrapper and
    the external ones."""
    from remixt_tpu_torch.wrappers import catalog
    monkeypatch.setattr(wrapexternal.ExternalTool, 'check_available',
                        lambda self: None)
    for cls in catalog.values():
        with pytest.raises(ValueError, match='exactly one tumour'):
            cls({}, str(tmp_path)).create_workflow(
                {'n': 'n.h5', 't1': 't1.h5', 't2': 't2.h5'},
                'breakpoints.tsv', str(tmp_path / 'results.h5'),
                str(tmp_path / 'wd'), normal_id='n')


def test_clonehd_conversion(tmp_path):
    """tests/test_wrappers.py's case: two clones, the report byte-equal to
    the JAX report."""
    d = tmp_path / 'clonehd'
    os.makedirs(d)
    with open(d / 'tumour.summary.txt', 'w') as f:
        f.write('# 2 clones\n1.2 0.5 0.3\n')
    rows = {
        'cna.subclone-1': [['1', 1000, 10000, 10, 0.0, 0.1, 0.8, 0.1],
                           ['1', 11000, 20000, 10, 0.0, 0.1, 0.2, 0.7]],
        'baf.subclone-1': [['1', 1000, 10000, 10, 0.1, 0.8, 0.1, 0.0],
                           ['1', 11000, 20000, 10, 0.1, 0.8, 0.1, 0.0]],
        'cna.subclone-2': [['1', 1000, 10000, 10, 0.0, 0.1, 0.8, 0.1],
                           ['1', 11000, 20000, 10, 0.0, 0.1, 0.8, 0.1]],
        'baf.subclone-2': [['1', 1000, 10000, 10, 0.7, 0.2, 0.1, 0.0],
                           ['1', 11000, 20000, 10, 0.1, 0.8, 0.1, 0.0]],
    }
    for name, table in rows.items():
        posterior(d / 'tumour.{}.txt'.format(name), table, 4)
    outputs = {}
    for name, module in (('jax', jax_clonehd), ('port', wrapclonehd)):
        outputs[name] = [str(tmp_path / '{}_{}.tsv'.format(name, kind))
                         for kind in ('cn', 'mix')]
        module.report(str(d), *outputs[name])
    for got, ref in zip(outputs['port'], outputs['jax']):
        assert filecmp.cmp(got, ref, shallow=False)
    cn = read_tsv(outputs['port'][0], str_columns=('chromosome',))
    assert cn['total_1'].tolist() == [2, 3]
    assert cn['major_1'].tolist() == [1, 2]
    assert cn['minor_1'].tolist() == [1, 1]
    assert cn['major_2'].tolist() == [2, 1]
    assert cn['minor_2'].tolist() == [0, 1]


# ---------------------------------------------------------------------------
# the parsers, branch by branch
# ---------------------------------------------------------------------------

TITAN_SEGMENTS = pd.DataFrame({
    'Chromosome': ['1', '1', '2', '2', 'X'],
    'Start_Position(bp)': [1, 5001, 1, 7001, 1],
    'End_Position(bp)': [5000, 9000, 7000, 9000, 4000],
    'Copy_Number': [2, 3, 1, 4, 2],
    'MajorCN': [1, 2, 1, 3, 2],
    'MinorCN': [1, 1, 0, 1, 0],
    'Clonal_Cluster': [1, 2, np.nan, 2, 1],
})


@pytest.mark.parametrize('case', ['two clusters', 'one cluster',
                                  'tied restarts', 'clonal only'])
def test_titan_parsers(tmp_path, case):
    """read_params, select_best_restart (the first of equals),
    convert_mix and convert_cn_table (a missing Clonal_Cluster counts as
    1, subclonal rows get a diploid clone 2) give the JAX values."""
    scores = {'two clusters': [0.5, 0.2, 0.3, 0.25],
              'one cluster': [0.1, 0.2, 0.3, 0.25],
              'tied restarts': [0.4, 0.2, 0.3, 0.2],
              'clonal only': [0.3, 0.2, 0.3, 0.3]}[case]
    params = {}
    for idx, sdbw in enumerate(scores):
        clusters = 1 + idx % 2
        path = tmp_path / 'params_{}.txt'.format(idx)
        path.write_text(
            'Normal contamination estimate: 0.3{}\n'
            'Average tumour ploidy estimate: 2.5\n'
            'S_Dbw validity index: {}\n'
            'Clonal cluster cellular prevalence Z={}: {}\n'
            'a line without a colon\n'.format(
                idx, sdbw, clusters, '0.91 0.37' if clusters == 2
                else '0.85'))
        got, ref = wraptitan.read_params(path), jax_titan.read_params(path)
        assert list(got) == list(ref)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
        params[idx] = got
    best = wraptitan.select_best_restart(params)
    assert best == jax_titan.select_best_restart(params)
    clusters = 1 + best % 2
    assert wraptitan.convert_mix(params[best], clusters) == \
        jax_titan.convert_mix(params[best], clusters)
    for module in (wraptitan, jax_titan):
        with pytest.raises(ValueError, match='unsupported cluster count'):
            module.convert_mix(dict(params[best], **{
                'Clonal cluster cellular prevalence Z=3': np.ones(3)}), 3)
    segments = TITAN_SEGMENTS.copy()
    if case == 'clonal only':
        segments['Clonal_Cluster'] = 1
    path = tmp_path / 'cn.tsv'
    segments.to_csv(path, sep='\t', index=False)
    ref = jax_titan.convert_cn_table(pd.read_csv(
        path, sep='\t', converters={'Chromosome': str}))
    got = wraptitan.convert_cn_table(read_tsv(
        path, str_columns=('Chromosome',)))
    assert_same_table(got, ref)


@pytest.mark.parametrize('case', ['several rows', 'tie', 'one clone',
                                  'one interval'])
def test_theta_parse_results(tmp_path, case):
    """parse_results: the least NLL + BAF_NLL (the first of equals), mu
    split on ',', C on ':' then ',', a one-clone C copied into total_2."""
    results = {
        'several rows': [('100.', '0.4,0.35,0.25', '2,1:3,2:2,2', '-', '30'),
                         ('90.', '0.5,0.3,0.2', '2,2:3,1:1,1', '-', '20.5'),
                         ('95.', '0.6,0.2,0.2', '1,2:3,3:2,1', '-', '10')],
        'tie': [('100.', '0.4,0.35,0.25', '2,1:3,2:2,2', '-', '30'),
                ('110.', '0.5,0.3,0.2', '2,2:3,1:1,1', '-', '20'),
                ('90.', '0.6,0.2,0.2', '1,2:3,3:2,1', '-', '40')],
        'one clone': [('100.', '0.4,0.6', '2:3:1', '-', '30'),
                      ('99.', '0.45,0.55', '2:1:4', '-', '30')],
        'one interval': [('100.', '0.4,0.6', '3', '-', '30')],
    }[case]
    counts = [(0, 0, 0, 5000, 10, 9, 5, 0), (1, 0, 5000, 9000, 7, 8, 5, 0),
              (2, 1, 0, 7000, 11, 10, 5, 0)]
    if case == 'one interval':
        counts = counts[:1]
    counts_path = tmp_path / 'counts.tsv'
    counts_path.write_text(''.join('\t'.join(map(str, row)) + '\n'
                                   for row in counts))
    theta_results(tmp_path / 'results.tsv', results)
    chrom_names = {0: '1', 1: '2'}
    got_table, got_mix = wraptheta.parse_results(
        tmp_path / 'results.tsv', counts_path, chrom_names)
    ref_table, ref_mix = jax_theta.parse_results(
        tmp_path / 'results.tsv', counts_path, chrom_names)
    assert got_mix == ref_mix
    assert_same_table(got_table, ref_table)


@pytest.mark.parametrize('case', ['nan and ties', 'all nan',
                                  'named chromosome'])
def test_clonehd_parsers(tmp_path, case):
    """_argmax_calls (NaN as 0, the first of equals, the label as the
    call), clone_cn_table (a call with allele > total clamps the minor to
    0) and parse_summary give the JAX values."""
    nan = np.nan
    chrom = 'X' if case == 'named chromosome' else '3'
    cna = [[chrom, 1000, 10000, 10, 0.1, nan, 0.5, 0.5, 0.1],
           [chrom, 11000, 30000, 20, 0.0, 0.1, 0.2, 0.7, nan],
           [chrom, 31000, 50000, 20, 0.2, 0.2, 0.2, 0.2, 0.2]]
    baf = [[chrom, 1500, 20500, 8, nan, 0.1, 0.2, 0.6, 0.1],
           [chrom, 21500, 48500, 9, 0.1, 0.7, 0.1, 0.1, nan]]
    if case == 'all nan':
        cna[0][4:] = [nan] * 5
        baf[1][4:] = [nan] * 5
    posterior(tmp_path / 'cna.txt', cna, 5, sep='\t')
    posterior(tmp_path / 'baf.txt', baf, 5)
    for path, bin_size in ((tmp_path / 'cna.txt', 1000),
                           (tmp_path / 'baf.txt', None)):
        assert_same_table(wrapclonehd._argmax_calls(path, bin_size),
                          jax_clonehd._argmax_calls(path, bin_size))
    got = wrapclonehd.clone_cn_table(tmp_path / 'cna.txt',
                                     tmp_path / 'baf.txt', 2)
    ref = jax_clonehd.clone_cn_table(tmp_path / 'cna.txt',
                                     tmp_path / 'baf.txt', 2)
    assert_same_table(got, ref)
    if case == 'nan and ties':
        assert (got['major_2'] > got['total_2']).any()
        assert (got['minor_2'] == 0).any()
    summary = tmp_path / 'summary.txt'
    summary.write_text('# 3 clones\n1.5 0.25 0.125 0.0625\n')
    assert wrapclonehd.parse_summary(summary) == \
        jax_clonehd.parse_summary(summary)


# ---------------------------------------------------------------------------
# the tools' workflows through the scheduler, under the stand-ins
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def standins(seqdata):
    """The stand-in bin directory, the config of the three tools (with
    the chromosomes and their FASTA index) and each package's mixture of
    a simulation over CHROMOSOMES."""
    cs = chip_smoke()
    root = seqdata['root']
    bin_dir = cs.write_standin_tools(str(root / 'bin'))
    fai = root / 'genome.fa.fai'
    fai.write_text(''.join('{}\t{}\t0\t60\t61\n'.format(c, n)
                           for c, n in CHROMOSOMES.items()))
    segments = str(root / 'segments.tsv')
    windows().to_csv(segments, sep='\t', index=False)
    config = dict(cs.caller_config(bin_dir, segments),
                  genome_fai_filename=str(fai),
                  chromosomes=list(CHROMOSOMES))
    params = dict(PARAMS, N=60, random_seed=SEED,
                  chromosome_lengths=dict(CHROMOSOMES))
    mixtures = {}
    for name, sim in (('jax', jax_sim), ('port', torch_sim)):
        mixtures[name] = str(root / '{}_mixture.pickle'.format(name))
        sim.simulate_genome_mixture(mixtures[name], None, params)
    return dict(cs=cs, bin_dir=bin_dir, config=config, mixtures=mixtures)


def run_tool(module, tool, config, stores, root, suffix='.h5'):
    """A tool's workflow on ``stores`` into ``root``: (results store, its
    name ending in ``suffix``, work directory)."""
    tool = getattr(module, TOOL_CLASSES[tool])(config, str(root))
    workdir = os.path.join(root, tool.name)
    results = os.path.join(root, 'results_' + tool.name) + suffix
    tool.create_workflow(stores, 'breakpoints.tsv', results, workdir,
                         normal_id='normal').run(os.path.join(root, 'work'))
    return results, workdir


def tool_calls(cs, bin_dir, root):
    return [call.replace(str(root), '@ROOT@')
            for call in cs.tool_calls(bin_dir)]


@pytest.mark.parametrize('kind', ['torch_dir', 'torch_h5'])
@pytest.mark.parametrize('tool', TOOLS)
def test_tool_workflow_equals_jax(seqdata, standins, tmp_path, tool, kind):
    """Each tool's workflow under the stand-ins, the port's on its own
    seqdata store into a results directory (HDF5 for ``torch_h5``), the
    JAX package's on its file: the same inputs, stand-in calls, cn table,
    mix and evaluation."""
    cs, bin_dir = standins['cs'], standins['bin_dir']
    stores = {'jax': seqdata['jax_h5'], 'port': seqdata[kind]}
    runs, calls = {}, {}
    cs.tool_calls(bin_dir)
    with cs.first_on_path(bin_dir):
        for name, module in (('jax', jax_external), ('port', wrapexternal)):
            root = tmp_path / name
            runs[name] = run_tool(
                module, tool, standins['config'], stores[name], root,
                '' if name == 'port' and kind == 'torch_dir' else '.h5')
            calls[name] = tool_calls(cs, bin_dir, root)
    assert calls['port'] == calls['jax']
    assert len(calls['port']) == {'titan': 4, 'theta': 2, 'clonehd': 5}[tool]
    (ref_results, ref_dir), (results, workdir) = runs['jax'], runs['port']
    for name in sorted(os.listdir(ref_dir)):
        if os.path.isfile(os.path.join(ref_dir, name)):
            assert filecmp.cmp(os.path.join(workdir, name),
                               os.path.join(ref_dir, name),
                               shallow=False), name

    got = read_store(results)
    with JaxStore(ref_results, 'r') as store:
        assert_same_table(got['cn'], store['/cn'])
        assert got['mix'].values.tolist() == store['/mix'].values.tolist()
        assert got['mix'].index.tolist() == [0, 1, 2]
        ref_brk = store['/brk_cn']
    assert got['brk_cn'].columns == list(ref_brk.columns) == [
        'prediction_id', 'cn_1', 'cn_2']
    assert len(got['brk_cn']) == len(ref_brk.index) == 0
    assert ('major_1' in got['cn']) == (tool != 'theta')

    evaluations = {}
    for name, sim, results_file in (('jax', jax_sim, ref_results),
                                    ('port', torch_sim, results)):
        evaluations[name] = str(tmp_path / 'evaluation_{}.h5'.format(name))
        sim.evaluate_results_task(
            evaluations[name], results_file,
            mixture_filename=standins['mixtures'][name])
    got = read_store(evaluations['port'])
    with JaxStore(evaluations['jax'], 'r') as store:
        for key in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results'):
            ref = store['/' + key]
            assert got[key].index.tolist() == ref.index.tolist(), key
            np.testing.assert_allclose(got[key].values, ref.values,
                                       rtol=RTOL, atol=0, err_msg=key)


def test_standins_reach_every_parser_branch(seqdata, standins, tmp_path):
    """On the seqdata, the stand-ins' outputs reach the branches the
    parsers have: TITAN's best restart is not the first and has subclonal
    rows and an empty Clonal_Cluster; THetA writes several rows with two
    clones; cloneHD two clones with NaN cells, a tie and a call with
    allele > total."""
    cs, bin_dir = standins['cs'], standins['bin_dir']
    with cs.first_on_path(bin_dir):
        for tool in TOOLS:
            run_tool(wrapexternal, tool, standins['config'],
                     seqdata['torch_dir'], tmp_path, '')
    cs.tool_calls(bin_dir)
    titan = str(tmp_path / 'titan')
    params = {i: wraptitan.read_params(os.path.join(
        titan, 'restart_{}'.format(i), 'params.txt')) for i in range(4)}
    best = wraptitan.select_best_restart(params)
    assert best != 0
    segments = pd.read_csv(os.path.join(titan, 'restart_{}'.format(best),
                                        'cn.tsv'), sep='\t')
    assert segments['Clonal_Cluster'].isna().any()
    assert (segments['Clonal_Cluster'] == 2).any()
    assert len(set(segments['Copy_Number'])) > 1

    theta = pd.read_csv(str(tmp_path / 'theta' / 'theta2.BAF.NLL.results'),
                        sep='\t')
    assert len(theta.index) > 1
    assert all(len(c.split(':')[0].split(',')) == 2 for c in theta['C'])

    clonehd = str(tmp_path / 'clonehd')
    assert wrapclonehd.parse_summary(os.path.join(
        clonehd, 'tumour.summary.txt'))['num_clones'] == 2
    texts = [open(os.path.join(clonehd, 'tumour.{}.subclone-{}.txt'.format(
        kind, clone))).read() for kind in ('cna', 'baf') for clone in (1, 2)]
    assert all('nan' in text for text in texts)
    cn = read_tsv(os.path.join(clonehd, 'cn.tsv'))
    assert ((cn['major_1'] > cn['total_1']) & (cn['minor_1'] == 0)).any()
    ties = [line.split()[4:] for line in texts[0].splitlines()[1:]]
    assert any(sorted(row)[-1] == sorted(row)[-2] for row in ties)


def test_standin_refuses_a_file_without_the_tool_columns(standins,
                                                         tmp_path):
    """A stand-in exits non-zero where an input lacks the tool's
    columns."""
    import subprocess
    bad = tmp_path / 'counts.tsv'
    bad.write_text('0\t0\t0\t5000\t10\n')
    done = subprocess.run([os.path.join(standins['bin_dir'], 'RunTHetA'),
                           str(bad), '--FORCE', '--NUM_INTERVALS', '15',
                           '--OUTPUT_PREFIX', str(tmp_path / 'theta')],
                          capture_output=True, text=True)
    assert done.returncode != 0 and 'not 8' in done.stderr
    standins['cs'].tool_calls(standins['bin_dir'])


@pytest.mark.parametrize('tool', TOOLS)
def test_check_available_raises_the_jax_message(tmp_path, monkeypatch,
                                                tool):
    """Without the tool's binaries on the PATH both packages refuse with
    the same message."""
    monkeypatch.setenv('PATH', str(tmp_path))
    messages = []
    for module in (jax_external, wrapexternal):
        with pytest.raises(RuntimeError) as error:
            getattr(module, TOOL_CLASSES[tool])({}, str(tmp_path)) \
                .check_available()
        messages.append(str(error.value))
    assert messages[0] == messages[1]
    assert 'requires binaries not on PATH' in messages[1]


def test_theta_without_segments_raises(seqdata, standins, tmp_path):
    """A THetA config without ``theta.segments_filename``: the port's
    create_workflow raises ValueError naming the key before any task runs;
    the JAX workflow fails when its prepare task reads the missing file."""
    cs = standins['cs']
    config = dict(standins['config'], theta={
        k: v for k, v in standins['config']['theta'].items()
        if k != 'segments_filename'})
    stores = seqdata['jax_h5']
    with cs.first_on_path(standins['bin_dir']):
        with pytest.raises(ValueError, match='theta.segments_filename'):
            wrapexternal.ThetaTool(config, str(tmp_path)).create_workflow(
                stores, 'breakpoints.tsv', str(tmp_path / 'results'),
                str(tmp_path / 'port'), normal_id='normal')
        assert not os.path.exists(tmp_path / 'port' / 'counts.tsv')
        workflow = jax_external.ThetaTool(config, str(tmp_path)) \
            .create_workflow(stores, 'breakpoints.tsv',
                             str(tmp_path / 'results.h5'),
                             str(tmp_path / 'jax'), normal_id='normal')
        with pytest.raises(Exception):
            workflow.run(str(tmp_path / 'work'))
    assert cs.tool_calls(standins['bin_dir']) == []


def test_catalog_and_runners_offer_every_tool():
    """The catalog holds the JAX package's four tools, and both runners
    offer them."""
    import argparse
    from remixt_tpu.wrappers import catalog as jax_catalog
    from remixt_tpu_torch.benchmark import run_read_benchmark
    from remixt_tpu_torch.wrappers import catalog
    assert list(catalog) == list(jax_catalog) == [
        'remixt', 'titan', 'theta', 'clonehd']
    parser = argparse.ArgumentParser()
    run_read_benchmark.add_arguments(parser)
    args = parser.parse_args(['raw', 'table', '--tools'] + list(catalog))
    assert args.tools == list(catalog)
    for name in TOOLS:
        assert catalog[name]({}, '.', device='cuda').tool_config == {}
