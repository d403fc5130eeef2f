"""The port's last three host functions against the JAX package's, on the
CPU: ``segalg.aggregate_adjacent`` (tests/test_segalg.py's case and random
runs across chromosomes), ``utils.BreakpointDatabase`` (tests/
test_segalg.py's case and random queries at several ``extend``, with
misses and ties) and ``seqdataio.merge_overlapping_seqdata``
(tests/test_prep.py's cases, in HDF5 files and directories, with
overlapping chromosomes and an empty table).

``aggregate_adjacent``'s length-weighted means are held at rtol 1e-12,
every other column exactly; the matcher's answers and the merged stores
exactly.
"""

import numpy as np
import pandas as pd
import pytest

import remixt_tpu.segalg as jax_segalg
import remixt_tpu.seqdataio as jax_seqdataio
from remixt_tpu.utils import BreakpointDatabase as JaxBreakpointDatabase
from remixt_tpu_torch import segalg, seqdataio
from remixt_tpu_torch.io.table import Table
from remixt_tpu_torch.utils import BreakpointDatabase

NORMALIZED = ('major_raw', 'minor_raw')


def as_table(frame):
    return Table([(name, frame[name].values) for name in frame.columns])


def assert_same_aggregate(got, ref):
    assert got.columns == list(ref.columns)
    assert got.index.tolist() == ref.index.tolist()
    for name in ref.columns:
        want = ref[name].values
        if name in NORMALIZED:
            np.testing.assert_allclose(got[name], want, rtol=1e-12, atol=0,
                                       err_msg=name)
        elif want.dtype.kind == 'f':
            np.testing.assert_array_equal(got[name], want, err_msg=name)
            assert got[name].dtype == want.dtype, name
        else:
            assert got[name].tolist() == want.tolist(), name


def segalg_case():
    return pd.DataFrame({
        'chromosome': ['1'] * 4,
        'start': [0, 10, 20, 30],
        'end': [10, 20, 30, 40],
        'length': [10.0, 10.0, 30.0, 10.0],
        'major_1': [1, 1, 2, 2],
        'minor_1': [1, 1, 0, 0],
        'major_2': [1, 1, 2, 2],
        'minor_2': [1, 1, 0, 0],
        'major_raw': [1.1, 0.9, 2.2, 1.8],
        'minor_raw': [1.0, 1.0, 0.1, 0.0],
        'major_raw_e': [1.0, 1.0, 2.0, 2.0],
        'minor_raw_e': [1.0, 1.0, 0.0, 0.0],
    })


def random_case(seed, n=400):
    """Segments over three chromosomes whose copy numbers repeat in runs,
    with float lengths and a few missing expectations."""
    rng = np.random.RandomState(seed)
    chromosome = np.sort(rng.choice(['1', '2', 'X'], size=n))
    state = np.cumsum(rng.rand(n) < 0.3)
    major = 1 + state % 3
    minor = state % 2
    lengths = rng.uniform(1e3, 1e6, size=n)
    ends = np.cumsum(lengths.astype(np.int64))
    frame = pd.DataFrame({
        'chromosome': chromosome,
        'start': ends - lengths.astype(np.int64),
        'end': ends,
        'length': lengths,
        'major_1': major, 'minor_1': minor,
        'major_2': np.where(rng.rand(n) < 0.05, major + 1, major),
        'minor_2': minor,
        'major_raw': major + rng.normal(0, 0.2, size=n),
        'minor_raw': minor + rng.normal(0, 0.2, size=n),
        'major_raw_e': major + rng.normal(0, 0.1, size=n),
        'minor_raw_e': minor + rng.normal(0, 0.1, size=n),
    })
    frame.loc[rng.rand(n) < 0.1, 'major_raw_e'] = np.nan
    return frame


@pytest.mark.parametrize('case', ['segalg', 'random 1', 'random 2',
                                  'random, value and length columns'])
def test_aggregate_adjacent_equals_jax(case):
    """tests/test_segalg.py's case, then random runs across chromosomes:
    runs broken by the chromosome and the value columns, the stable columns'
    first value (missing ones skipped), start's least, end's greatest,
    length's sum, the length-weighted means."""
    kwargs = {}
    if case == 'segalg':
        frame = segalg_case()
    else:
        frame = random_case(int(case[-1]) if case[-1].isdigit() else 3)
    if case.startswith('random, value'):
        kwargs = dict(value_cols=['major_1'],
                      stable_cols=['chromosome', 'minor_1', 'major_raw_e'],
                      length_normalized_cols=['major_raw'])
    ref = jax_segalg.aggregate_adjacent(frame, **kwargs)
    got = segalg.aggregate_adjacent(as_table(frame), **kwargs)
    assert_same_aggregate(got, ref)
    if case == 'segalg':
        assert got['start'].tolist() == [0, 20]
        assert got['end'].tolist() == [20, 40]
        np.testing.assert_allclose(got['major_raw'][1],
                                   (2.2 * 30 + 1.8 * 10) / 40)
    else:
        assert 10 < len(got) < len(frame)


def breakpoint_frame(rows):
    return pd.DataFrame(rows, columns=[
        'prediction_id', 'chromosome_1', 'strand_1', 'position_1',
        'chromosome_2', 'strand_2', 'position_2'])


def test_breakpoint_database_fuzzy_query():
    """tests/test_segalg.py's case."""
    table = breakpoint_frame([('a', '1', '+', 1000, '2', '-', 2000),
                              ('b', '1', '+', 5000, '1', '-', 9000)])
    db = BreakpointDatabase(as_table(table))
    exact = {'chromosome_1': '1', 'strand_1': '+', 'position_1': 1000,
             'chromosome_2': '2', 'strand_2': '-', 'position_2': 2000}
    assert db.query(exact, extend=0) == 'a'
    swapped = {'chromosome_1': '2', 'strand_1': '-', 'position_1': 2000,
               'chromosome_2': '1', 'strand_2': '+', 'position_2': 1000}
    assert db.query(swapped, extend=0) == 'a'
    fuzzy = dict(exact, position_1=1004, position_2=1997)
    assert db.query(fuzzy, extend=0) is None
    assert db.query(fuzzy, extend=5) == 'a'
    cross = dict(exact, position_1=5000, chromosome_2='2')
    assert db.query(cross, extend=0) is None
    near_b = {'chromosome_1': '1', 'strand_1': '+', 'position_1': 5001,
              'chromosome_2': '1', 'strand_2': '-', 'position_2': 8999}
    assert db.query(near_b, extend=2) == 'b'


@pytest.mark.parametrize('ids', ['int', 'str'])
def test_breakpoint_database_random_queries_equal_jax(ids):
    """Random breakpoints on two chromosomes with duplicated rows and
    breakends sharing positions (ties broken by prediction id), probed at
    their own breakends moved a little and at random places, at several
    ``extend``: the JAX answers, misses (None) among them."""
    rng = np.random.RandomState(7)
    n = 80

    def draw(size):
        return (rng.choice(['1', '2'], size=size),
                rng.choice(['+', '-'], size=size),
                rng.randint(0, 20000, size=size) // 50 * 50)

    chrom_1, strand_1, pos_1 = draw(n)
    chrom_2, strand_2, pos_2 = draw(n)
    pid = np.arange(n) if ids == 'int' else np.array(
        ['p{:03d}'.format(i) for i in rng.permutation(n)], dtype=object)
    rows = list(zip(pid, chrom_1, strand_1, pos_1, chrom_2, strand_2, pos_2))
    rows += rows[:5]
    rows += [(pid[0] if ids == 'int' else 'p999', *rows[1][1:])]
    table = breakpoint_frame(rows)
    db, ref_db = BreakpointDatabase(as_table(table)), \
        JaxBreakpointDatabase(table)
    queries = []
    for row in rows[:40]:
        move = rng.randint(-120, 121, size=2)
        queries.append({'chromosome_1': row[1], 'strand_1': row[2],
                        'position_1': int(row[3] + move[0]),
                        'chromosome_2': row[4], 'strand_2': row[5],
                        'position_2': int(row[6] + move[1])})
    for _ in range(40):
        c1, s1, p1 = draw(1)
        c2, s2, p2 = draw(1)
        queries.append({'chromosome_1': c1[0], 'strand_1': s1[0],
                        'position_1': int(p1[0]), 'chromosome_2': c2[0],
                        'strand_2': s2[0], 'position_2': int(p2[0])})
    answers = []
    for extend in (0, 10, 100, 1000, 5000):
        for query in queries:
            got, ref = db.query(query, extend), ref_db.query(query, extend)
            assert got == ref, (query, extend)
            answers.append(ref)
    assert None in answers and len(set(answers) - {None}) > 20


def write_store(path, writer_module, tables):
    """``{chromosome: (fragments, alleles)}`` column dicts written by a
    package's seqdata writer (the JAX one takes DataFrames)."""
    writer = writer_module.Writer(path)
    for chromosome, (fragments, alleles) in tables.items():
        if writer_module is jax_seqdataio:
            writer.write(chromosome, pd.DataFrame(fragments),
                         pd.DataFrame(alleles, columns=[
                             'fragment_id', 'position', 'is_alt'])
                         .astype(int))
        else:
            writer.write(chromosome, Table(fragments),
                         Table([(c, np.asarray(alleles.get(c, []),
                                               dtype=np.int64))
                                for c in ('fragment_id', 'position',
                                          'is_alt')]))
    writer.close()
    return path


def store_tables(rng, chromosomes, empty_alleles=()):
    tables = {}
    for chromosome, n in chromosomes.items():
        fragments = dict(fragment_id=np.arange(n),
                         start=np.sort(rng.randint(0, 10 ** 6, size=n)))
        fragments['end'] = fragments['start'] + 150
        alleles = {} if chromosome in empty_alleles else dict(
            fragment_id=rng.randint(n, size=2 * n),
            position=rng.randint(0, 10 ** 6, size=2 * n),
            is_alt=rng.randint(2, size=2 * n))
        tables[chromosome] = (fragments, alleles)
    return tables


@pytest.mark.parametrize('out_form', ['.h5', ''])
@pytest.mark.parametrize('in_form', ['.h5', ''])
def test_merge_overlapping_seqdata_equals_jax(tmp_path, in_form, out_form):
    """Three stores sharing chromosomes, one with an empty allele table and
    one lacking a chromosome, merged over the chromosomes asked for (one
    in no store): each table of the output equals the JAX merge of the
    same stores, fragment ids offset per chromosome and unique."""
    rng = np.random.RandomState(3)
    inputs = [store_tables(rng, {'1': 50, '2': 30}),
              store_tables(rng, {'1': 40, '2': 20}, empty_alleles={'1'}),
              store_tables(rng, {'2': 25, '3': 10})]
    jax_files, files = {}, {}
    for i, tables in enumerate(inputs):
        key = 'in{}'.format(i)
        jax_files[key] = write_store(str(tmp_path / 'jax_{}.h5'.format(i)),
                                     jax_seqdataio, tables)
        files[key] = write_store(
            str(tmp_path / 'port_{}{}'.format(i, in_form)), seqdataio,
            tables)
    chromosomes = ['1', '2', '3', '4']
    ref_file = str(tmp_path / 'jax_merged.h5')
    jax_seqdataio.merge_overlapping_seqdata(ref_file, jax_files, chromosomes)
    merged = str(tmp_path / ('merged' + out_form))
    seqdataio.merge_overlapping_seqdata(merged, files, chromosomes)

    assert seqdataio.read_chromosomes(merged) == {'1', '2', '3'}
    for chromosome in chromosomes:
        for record_type in ('fragments', 'alleles'):
            got = seqdataio.read_seq_data(merged, record_type, chromosome)
            ref = jax_seqdataio.read_seq_data(ref_file, record_type,
                                              chromosome)
            assert got.columns == list(ref.columns)
            for column in ref.columns:
                assert got[column].tolist() == ref[column].tolist(), (
                    chromosome, record_type, column)
    ids = seqdataio.read_seq_data(merged, 'fragments', '1')['fragment_id']
    assert len(ids) == 90 and len(np.unique(ids)) == 90


@pytest.mark.parametrize('form', ['.h5', ''])
def test_seqdata_merge(tmp_path, form):
    """tests/test_prep.py's two cases: a store merged with itself doubles
    its reads with unique ids; an empty allele table adds no ids."""
    rng = np.random.RandomState(5)
    path = write_store(str(tmp_path / ('store' + form)), seqdataio,
                       store_tables(rng, {'1': 60, '2': 40}))
    merged = str(tmp_path / ('merged' + form))
    seqdataio.merge_overlapping_seqdata(merged, {'a': path, 'b': path},
                                        ['1', '2'])
    reads = seqdataio.read_fragment_data(merged, '1', filter_duplicates=None,
                                         map_qual_threshold=None)
    assert len(reads) == 120
    alleles = seqdataio.read_allele_data(merged, '1')
    assert alleles['fragment_id'].max() > seqdataio.read_allele_data(
        path, '1')['fragment_id'].max()

    stores = {name: write_store(
        str(tmp_path / (name + form)), seqdataio,
        {'1': (dict(fragment_id=np.arange(n), start=np.arange(n) * 10,
                    end=np.arange(n) * 10 + 5), {})})
        for name, n in (('a', 50), ('b', 30))}
    merged = str(tmp_path / ('empty_allele_merged' + form))
    seqdataio.merge_overlapping_seqdata(merged, stores, ['1'])
    ids = seqdataio.read_fragment_data(
        merged, '1', filter_duplicates=None,
        map_qual_threshold=None)['fragment_id']
    assert len(ids) == 80 and ids.min() >= 0 and len(np.unique(ids)) == 80
