"""The port's experiment from count and breakpoint TSVs
(``remixt_tpu_torch.analysis.experiment``) and its TSV reader and output
tables, against the JAX package's on the same files: the model inputs
exact, the tables with the same columns, order, dtypes, index and values.

The breakpoint tables carry, beside the simulated truth's breakpoints, a
prediction on a chromosome that is not modelled, a wild-type mimic, a
loop-back onto one extremity, one beyond ``max_brk_dist`` and one within it
but off the extremities.
"""

import pickle

import numpy as np
import pandas as pd
import pytest

from remixt_tpu.analysis import experiment as jax_experiment
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch.analysis import experiment as torch_experiment
from remixt_tpu_torch.analysis.experiment import Experiment
from remixt_tpu_torch.io.table import Table, parse_float, read_tsv

from test_pipeline import make_tables


def add_odd_breakpoints(count_data, breakpoint_data, adjacencies):
    """The simulated breakpoints plus one of each kind the experiment must
    drop or keep: (unmodelled chromosome, wild-type mimic, loop-back,
    beyond max_brk_dist, within it off the extremities)."""
    start, end = count_data['start'].values, count_data['end'].values
    chrom = count_data['chromosome'].values
    n, m = sorted(adjacencies)[0]
    a, b = 1, len(start) - 2
    rows = [
        ('GL000220.1', '+', 1000, chrom[a], '-', start[a]),
        (chrom[n], '+', end[n], chrom[m], '-', start[m]),
        (chrom[a], '+', end[a], chrom[a], '+', end[a] + 10),
        (chrom[a], '+', end[a] + 1500, chrom[b], '-', start[b] - 900),
        (chrom[a], '+', end[a] + 500, chrom[b], '-', start[b] - 700),
    ]
    first = int(breakpoint_data['prediction_id'].max()) + 1 \
        if len(breakpoint_data.index) else 0
    odd = pd.DataFrame(
        [(first + i,) + row for i, row in enumerate(rows)],
        columns=['prediction_id', 'chromosome_1', 'strand_1', 'position_1',
                 'chromosome_2', 'strand_2', 'position_2'])
    return pd.concat([breakpoint_data, odd], ignore_index=True), first


def write_tsvs(tmp, seed, N=120):
    data = sim.simulate_experiment(
        N=N, M=3, h=(0.08, 0.05, 0.025), cn_max=6, num_events=15,
        num_chains=3, seed=seed)
    count_data, breakpoint_data = make_tables(data)
    breakpoint_data, first_odd = add_odd_breakpoints(
        count_data, breakpoint_data, data['adjacencies'])
    count_file = str(tmp / 'counts.tsv')
    breakpoint_file = str(tmp / 'breakpoints.tsv')
    count_data.to_csv(count_file, sep='\t', index=False)
    breakpoint_data.to_csv(breakpoint_file, sep='\t', index=False)
    return count_file, breakpoint_file, data, first_odd


def load(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def assert_column_equal(got, ref, name):
    """A port column against a pandas one: same values, and the same dtype
    (pandas' string dtypes against an object array of str)."""
    ref = np.asarray(ref)
    if ref.dtype.kind in ('O', 'U', 'T') or got.dtype == object:
        assert got.dtype == object, name
        assert [str(v) for v in got] == [str(v) for v in ref], name
    else:
        assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=name)


def assert_table_equal(got, ref, label):
    assert isinstance(got, Table), label
    assert got.columns == [str(c) for c in ref.columns], label
    np.testing.assert_array_equal(got.index, ref.index.values,
                                  err_msg=label)
    for name in ref.columns:
        assert_column_equal(got[name], ref[name].values,
                            '{} {}'.format(label, name))


@pytest.fixture(scope='module', params=[0, 1, 2])
def experiments(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp('torch_experiment_{}'.format(request.param))
    count_file, breakpoint_file, data, first_odd = write_tsvs(
        tmp, request.param)
    out = {}
    for cut, min_length in (('all segments', None),
                            ('min_length', float(np.median(data['l'])))):
        pair = []
        for module, name in ((jax_experiment, 'jax'),
                             (torch_experiment, 'torch')):
            path = str(tmp / '{}_{}.pickle'.format(name, min_length))
            module.create_experiment(count_file, breakpoint_file, path,
                                     min_length=min_length)
            pair.append(load(path))
        out[cut] = tuple(pair)
    return dict(data=data, first_odd=first_odd, by_cut=out,
                files=(count_file, breakpoint_file))


@pytest.mark.parametrize('cut', ['all segments', 'min_length'])
def test_create_experiment_matches(experiments, cut):
    ref, got = experiments['by_cut'][cut]
    if cut == 'min_length':
        assert 0 < got.x.shape[0] < experiments['data']['x'].shape[0]
    for name in ('x', 'l', 'segment_start', 'segment_end',
                 'segment_major_is_allele_a'):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
        assert getattr(got, name).dtype == getattr(ref, name).dtype, name
    assert_column_equal(got.segment_chromosome_id, ref.segment_chromosome_id,
                        'segment_chromosome_id')
    assert got.adjacencies == ref.adjacencies
    assert got.breakpoints == ref.breakpoints
    assert got.chains == list(ref.chains)
    assert_table_equal(got.breakpoint_segment_data,
                       ref.breakpoint_segment_data, 'breakpoint_segment_data')
    assert_table_equal(got.count_table, ref.count_data, 'count_table')


@pytest.mark.parametrize('cut', ['all segments', 'min_length'])
def test_breakpoints_iterate_as_jax_after_pickling(experiments, cut):
    """Read back from their pickles, both experiments give each
    breakpoint's breakends in the same order, which sets the slot order of
    a junction's breakends in the model."""
    ref, got = experiments['by_cut'][cut]
    assert list(got.breakpoints) == list(ref.breakpoints)
    assert [list(b) for b in got.breakpoints.values()] == \
        [list(b) for b in ref.breakpoints.values()]


def test_colliding_breakends_keep_their_order_through_pickles():
    """Two breakends in one hash slot swap their iteration order at every
    pickle round trip of a stored frozenset; an experiment made from
    tables builds its breakpoints anew from the segment table, in the JAX
    package's order."""
    table = {'prediction_id': np.array([16]), 'n_1': np.array([532]),
             'side_1': np.array([1]), 'n_2': np.array([410]),
             'side_2': np.array([1])}
    ref = jax_experiment.convert_breakpoints_to_dict(pd.DataFrame(table))
    stored = pickle.loads(pickle.dumps(ref))
    assert list(stored[16]) != list(ref[16])
    # as Experiment.from_tables makes it: no stored dict, the table
    experiment = Experiment(np.zeros((600, 3)), np.ones(600), set(), None)
    experiment.breakpoint_segment_data = Table(table)
    for _ in range(2):
        experiment = pickle.loads(pickle.dumps(experiment))
        assert list(experiment.breakpoints[16]) == list(ref[16])


def test_odd_breakpoints(experiments):
    """Of the added predictions only the one within max_brk_dist stays; the
    truth's breakpoints all map."""
    _, got = experiments['by_cut']['all segments']
    first = experiments['first_odd']
    kept = set(got.breakpoints)
    assert [p for p in range(first, first + 5) if p in kept] == [first + 4]
    assert set(experiments['data']['breakpoints']) <= kept


def test_read_tsv_dtypes_match_pandas(experiments, tmp_path):
    count_file, breakpoint_file = experiments['files']
    odd_file = str(tmp_path / 'odd.tsv')
    with open(odd_file, 'w') as f:
        f.write('i\tneg\tf\tgap\te\tb\ts\tmix\n'
                '1\t-3\t0.5\t1\t1e-3\tTrue\tx\t1\n'
                '2\t7\t0.16607708859341797\t\t2.5E+4\tFalse\ty\tz\n'
                '\n'
                '30\t+8\t578164.7947326368\tNA\t-7\tTrue\t3\t2.0\n')
    for path, converters in ((count_file, {'chromosome': str}),
                             (breakpoint_file, {'chromosome_1': str,
                                                'chromosome_2': str}),
                             (odd_file, {})):
        ref = pd.read_csv(path, sep='\t', converters=converters)
        got = read_tsv(path, str_columns=tuple(converters))
        assert got.columns == list(ref.columns)
        for name in ref.columns:
            values = ref[name].values
            if np.asarray(values).dtype.kind == 'f':
                assert got[name].dtype == np.float64, name
                np.testing.assert_array_equal(got[name], values, err_msg=name)
            else:
                assert_column_equal(got[name], values, name)


@pytest.mark.parametrize('text', [
    '0.16607708859341797', '578164.7947326368', '1234567890123456789012.5',
    '1e-320', '-0.0', '.5', '5.', '1.7976931348623157e308', '2.5E+4',
    '0.000000000000000000001234567890123456789'])
def test_parse_float_matches_pandas(text):
    import io
    ref = pd.read_csv(io.StringIO('a\n' + text + '\n'))['a'].values[0]
    got = parse_float(text)
    assert got == ref or (np.isnan(got) and np.isnan(ref)), (got, ref)
    assert np.signbit(got) == np.signbit(ref)


def test_output_tables_match(experiments):
    """Segment, copy-number and breakpoint copy-number tables from the same
    copy number and h, bit for bit, dtypes included."""
    ref_exp, got_exp = experiments['by_cut']['all segments']
    rng = np.random.RandomState(3)
    N = got_exp.x.shape[0]
    cn = rng.randint(0, 5, size=(N, 3, 2))
    h = np.array([0.08, 0.05, 0.025])
    brk_cn = {k: rng.randint(0, 3, size=3).astype(np.int32)
              for k in ref_exp.breakpoints}
    assert_table_equal(torch_experiment.create_segment_table(got_exp),
                       jax_experiment.create_segment_table(ref_exp), 'segment')
    assert_table_equal(torch_experiment.create_cn_table(got_exp, cn, h),
                       jax_experiment.create_cn_table(ref_exp, cn, h), 'cn')
    assert_table_equal(
        torch_experiment.create_brk_cn_table(
            brk_cn, got_exp.breakpoint_segment_data),
        jax_experiment.create_brk_cn_table(
            brk_cn, ref_exp.breakpoint_segment_data), 'brk_cn')
    empty = torch_experiment.create_brk_cn_table({}, None)
    assert empty.columns == ['prediction_id'] and len(empty) == 0


def test_experiment_without_breakpoints():
    count = Table([('chromosome', np.array(['1', '1', '2'], dtype=object)),
                   ('start', np.array([1, 101, 1])),
                   ('end', np.array([100, 200, 100])),
                   ('length', np.array([100., 100., 100.])),
                   ('major_readcount', np.array([3, 4, 5])),
                   ('minor_readcount', np.array([1, 2, 3])),
                   ('readcount', np.array([10, 12, 14]))])
    experiment = Experiment.from_tables(count)
    assert experiment.breakpoints == {}
    assert experiment.adjacencies == {(0, 1)}
    assert experiment.chains == [(0, 2), (2, 3)]
    assert experiment.segment_major_is_allele_a is None
    assert 'major_is_allele_a' not in torch_experiment.create_segment_table(
        experiment)
