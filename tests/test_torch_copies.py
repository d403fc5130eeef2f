"""The port keeps its own copies of the JAX package's numpy-only modules;
they must give the same results: state enumeration, segmentation remap,
the count-level simulation, the interval keys, the weighted resample, the
measurability of reads and the expected read counts, the reverse
complement, the common refinement of two segmentations, and the workflow
scheduler (the scheduler cases of ``tests/test_cli.py``, run against both
schedulers). The functions the port copied verbatim, and the code of the
BAM allele reader below its header comment, must stay equal to their
originals, character for character; the rewritten ones are held to the
JAX outputs elsewhere."""

import importlib
import inspect

import os
import time

import numpy as np
import pandas as pd
import pytest

from remixt_tpu import likelihood as jlikelihood
from remixt_tpu import scheduler as jscheduler
from remixt_tpu import segalg as jsegalg
from remixt_tpu import utils as jutils
from remixt_tpu.models import remap as jremap
from remixt_tpu.models import states as jstates
from remixt_tpu.simulations import simple as jsim
from remixt_tpu_torch import likelihood as tlikelihood
from remixt_tpu_torch import scheduler as tscheduler
from remixt_tpu_torch import segalg as tsegalg
from remixt_tpu_torch import utils as tutils
from remixt_tpu_torch.io.table import Table
from remixt_tpu_torch.models import remap as tremap
from remixt_tpu_torch.models import states as tstates
from remixt_tpu_torch.simulations import simple as tsim


@pytest.mark.parametrize('num_clones,cn_max', [(2, 3), (3, 4), (3, 6)])
def test_state_enumeration(num_clones, cn_max):
    cn = tstates.enumerate_cn_states(num_clones, 2, cn_max, 1)
    np.testing.assert_array_equal(
        cn, jstates.enumerate_cn_states(num_clones, 2, cn_max, 1))
    np.testing.assert_array_equal(
        tstates.enumerate_brk_states(num_clones, cn_max, 1),
        jstates.enumerate_brk_states(num_clones, cn_max, 1))
    for key, value in tstates.state_indicators(cn).items():
        np.testing.assert_array_equal(
            value, jstates.state_indicators(cn)[key], err_msg=key)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_simulation_and_remap(seed):
    kwargs = dict(N=120, M=3, cn_max=6, num_events=15, num_chains=3,
                  seed=seed)
    got, ref = tsim.simulate_experiment(**kwargs), \
        jsim.simulate_experiment(**kwargs)
    for key in ('cn', 'h', 'x', 'l'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got['adjacencies'] == ref['adjacencies']
    assert got['breakpoints'] == ref['breakpoints']

    breakpoints = list(ref['breakpoints'].values())
    t = tremap.SegmentRemap(120, ref['adjacencies'], breakpoints)
    j = jremap.SegmentRemap(120, ref['adjacencies'], breakpoints)
    for attr in ('seg_fwd_remap', 'seg_rev_remap', 'seg_is_original',
                 'is_telomere', 'breakpoint_idx', 'breakpoint_orient'):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr),
                                      err_msg=attr)
    for a, b in zip(t.expand_data(ref['x'], ref['l']),
                    j.expand_data(ref['x'], ref['l'])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('seed', [0, 1])
def test_numpy_copies(seed):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 30, size=200)
    positions = rng.randint(0, 2 ** 40, size=200)
    np.testing.assert_array_equal(tsegalg.composite_keys(codes, positions),
                                  jsegalg.composite_keys(codes, positions))
    data, weights = rng.rand(50), rng.rand(50)
    np.testing.assert_array_equal(
        tutils.weighted_resample(data, weights, seed=seed),
        jutils.weighted_resample(data, weights, seed=seed))
    x = rng.randint(0, 1000, size=(40, 3))
    phi = tlikelihood.estimate_phi(x)
    np.testing.assert_array_equal(phi, jlikelihood.estimate_phi(x))
    np.testing.assert_array_equal(
        tlikelihood.proportion_measureable_matrix(phi),
        jlikelihood.proportion_measureable_matrix(phi))


def _segments(rng, chromosomes, num_segments, index_offset):
    """Random non-overlapping segments over ``chromosomes`` with gaps, as a
    pandas frame and a port Table with the same index labels."""
    columns = {'chromosome': [], 'start': [], 'end': []}
    for chromosome in chromosomes:
        bounds = np.sort(rng.choice(10 ** 6, size=2 * num_segments,
                                    replace=False))
        columns['chromosome'] += [chromosome] * num_segments
        columns['start'] += bounds[0::2].tolist()
        columns['end'] += bounds[1::2].tolist()
    index = np.arange(len(columns['start'])) + index_offset
    frame = pd.DataFrame(columns, index=index)
    table = Table([(k, np.asarray(v)) for k, v in columns.items()],
                  index=index)
    return frame, table


@pytest.mark.parametrize('seed', [0, 1])
def test_simulation_helper_copies(seed):
    rng = np.random.RandomState(seed)
    sequence = ''.join(rng.choice(list('ACGTacgtN'), size=300))
    assert (tutils.reverse_complement(sequence)
            == jutils.reverse_complement(sequence))

    N = 40
    l = rng.randint(10 ** 3, 10 ** 6, size=N).astype(float)
    cn = rng.randint(0, 5, size=(N, 3, 2)).astype(float)
    h, phi = 0.1 * rng.rand(3), rng.uniform(0.05, 0.2, size=N)
    np.testing.assert_array_equal(
        tlikelihood.expected_read_count(l, cn, h, phi),
        jlikelihood.expected_read_count(l, cn, h, phi))
    cn[3] = -1.
    for module in (tlikelihood, jlikelihood):
        with pytest.raises(ValueError, match='invalid mu'):
            module.expected_read_count(l, cn, h, phi)

    frame_1, table_1 = _segments(rng, ['1', '2', 'X'], 12, 0)
    frame_2, table_2 = _segments(rng, ['2', '1', '3'], 9, 100)
    got = tsegalg.reindex_segments(table_1, table_2)
    ref = jsegalg.reindex_segments(frame_1, frame_2)
    assert got.columns == list(ref.columns) and len(got) > 0
    for name in ref.columns:
        np.testing.assert_array_equal(got[name], ref[name].values,
                                      err_msg=name)
    assert got['idx_2'].min() >= 100
    empty = Table([(c, np.array([], dtype=np.int64))
                   for c in ('chromosome', 'start', 'end')])
    assert len(tsegalg.reindex_segments(empty, table_2)) == 0
    assert tsegalg.reindex_segments(table_1, empty).columns == list(
        ref.columns)


# -- scheduler: tests/test_cli.py's cases, against both copies ----------------

def _write_file(path, content):
    with open(path, 'w') as f:
        f.write(content)


def _concat_files(out, *ins):
    with open(out, 'w') as f:
        for i in ins:
            f.write(open(i).read())


def _produce():
    return {'x': 41}


def _consume(out, value):
    _write_file(out, str(value + 1))


def _dag_and_resume(Workflow, tmp_path):
    a, b, c = (str(tmp_path / n) for n in ('a.txt', 'b.txt', 'c.txt'))

    def build():
        wf = Workflow('test')
        wf.transform('write_a', _write_file, args=(a, 'A'), outputs=[a])
        wf.transform('write_b', _write_file, args=(b, 'B'), outputs=[b])
        wf.transform('concat', _concat_files, args=(c, a, b),
                     inputs=[a, b], outputs=[c])
        return wf

    workdir = str(tmp_path / 'work')
    build().run(workdir)
    assert open(c).read() == 'AB'
    # resume: completed tasks are skipped, c untouched unless inputs change
    _write_file(c, 'TAMPERED')
    build().run(workdir)
    assert open(c).read() == 'TAMPERED'
    # touching an input forces the downstream rerun
    time.sleep(0.01)
    _write_file(a, 'A2')
    build().run(workdir)
    assert open(c).read() == 'A2B'


def _ret_values(Workflow, tmp_path):
    out = str(tmp_path / 'out.txt')
    wf = Workflow('retvals')
    ret = wf.transform('produce', _produce)
    wf.transform('consume', _consume, args=(out, ret['x']), outputs=[out])
    wf.run(str(tmp_path / 'work'))
    assert open(out).read() == '42'


def _missing_ret_reruns(Workflow, tmp_path):
    """A surviving sentinel whose return pickle is gone does not resume as
    completed."""
    out = str(tmp_path / 'out.txt')

    def build():
        wf = Workflow('retloss')
        ret = wf.transform('produce', _produce)
        wf.transform('consume', _consume, args=(out, ret['x']), outputs=[out])
        return wf

    workdir = str(tmp_path / 'work')
    build().run(workdir)
    assert open(out).read() == '42'
    os.remove(os.path.join(workdir, '.ret_produce.pickle'))
    os.remove(out)
    build().run(workdir)
    assert open(out).read() == '42'


def _parallel(Workflow, tmp_path):
    outs = [str(tmp_path / 'f{}.txt'.format(i)) for i in range(4)]
    wf = Workflow('par')
    for i, out in enumerate(outs):
        wf.transform('write_{}'.format(i), _write_file, args=(out, str(i)),
                     outputs=[out])
    merged = str(tmp_path / 'merged.txt')
    wf.transform('merge', _concat_files, args=tuple([merged] + outs),
                 inputs=outs, outputs=[merged])
    wf.run(str(tmp_path / 'work'), max_jobs=3)
    assert open(merged).read() == '0123'


SCHEDULER_CASES = {'dag_and_resume': _dag_and_resume,
                   'ret_values': _ret_values,
                   'missing_ret_reruns': _missing_ret_reruns,
                   'parallel': _parallel}


@pytest.mark.parametrize('scheduler', [jscheduler, tscheduler],
                         ids=['jax', 'torch'])
@pytest.mark.parametrize('case', list(SCHEDULER_CASES))
def test_scheduler(case, scheduler, tmp_path):
    SCHEDULER_CASES[case](scheduler.Workflow, tmp_path)


# functions of the run path copied verbatim: (module under both packages,
# name)
VERBATIM = [('segalg', name) for name in (
    'find_contained_positions', 'find_contained_segments',
    'contained_counts', 'overlapping_counts', 'vrange',
    'interval_position_overlap')] + [
    ('utils', 'read_sequences'), ('utils', 'sort_chromosome_names'),
    ('utils', 'merge_files'), ('utils', 'link_file'),
    ('config', 'get_full_config'), ('config', 'get_filename'),
    ('config', 'get_chromosomes'),
    ('analysis.segment', '_merge_intervals'),
    ('analysis.haplotype', '_haplotype_blocks'),
    ('analysis.haplotype', '_run'),
    ('parallel.distributed', 'factor_devices')] + [
    ('analysis.gcbias', name) for name in (
        'lowess', '_GenomeCoords', 'GCCurve', '_accumulate_matching_counts',
        '_fragment_start_probabilities', 'calculate_segment_gc_map_bias')]


@pytest.mark.parametrize('module,name', VERBATIM,
                         ids=['.'.join(v) for v in VERBATIM])
def test_verbatim_copies(module, name):
    source = [inspect.getsource(getattr(importlib.import_module(
        package + '.' + module), name))
        for package in ('remixt_tpu', 'remixt_tpu_torch')]
    assert source[0] == source[1]


def test_bam_allele_reader_source_is_a_copy():
    """The port's C++ source is the JAX package's from its first
    ``#include`` on, byte for byte; only the header comment differs."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sources = []
    for path in (('src',), ('remixt_tpu_torch', 'csrc')):
        with open(os.path.join(repo, *path, 'bam_allele_reader.cpp'),
                  'rb') as f:
            text = f.read()
        head, code = text.split(b'#include', 1)
        assert all(line.startswith(b'//') for line in head.splitlines()
                   if line.strip())
        sources.append(code)
    assert sources[0] == sources[1]
