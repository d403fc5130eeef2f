"""The port's seqdata store (``remixt_tpu_torch/seqdataio.py``) against
the JAX package's: an HDF5 file written by the port is read by the JAX
package and the JAX package's file by the port; the port's directory form
gives the same tables as its HDF5 form, whole, filtered and in chunks;
appended chunks (with their fragment ids continuing, as the BAM reader's
batches) and ``merge_seqdata`` (an empty allele table included) give the
JAX package's tables."""

import numpy as np
import pandas as pd
import pytest

import remixt_tpu.seqdataio as jax_seqdataio
from remixt_tpu_torch import seqdataio
from remixt_tpu_torch.io.table import Table

FILTERS = [dict(filter_duplicates=None, map_qual_threshold=None,
                keep_cols=True),
           dict(filter_duplicates=True, map_qual_threshold=30),
           dict(filter_duplicates=False, map_qual_threshold=1)]


def tables(seed=0, n=10000):
    """Fragment and allele tables from a seed, as pandas frames."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, int(1e6), size=n)
    fragments = pd.DataFrame({
        'fragment_id': np.arange(n),
        'start': start,
        'end': start + rng.randint(100, 400, size=n),
        'mapping_quality': rng.choice([0, 10, 60], size=n),
        'is_duplicate': rng.choice([0, 1], size=n, p=[0.95, 0.05]),
    })
    alleles = pd.DataFrame({
        'fragment_id': rng.randint(0, n, size=2 * n),
        'position': rng.randint(0, int(1e6), size=2 * n),
        'is_alt': rng.randint(0, 2, size=2 * n),
    })
    return fragments, alleles


def as_table(frame):
    return Table([(c, frame[c].values) for c in frame.columns])


# (chromosome, fragment rows, allele rows) of each appended chunk
CHUNKS = [('1', slice(0, 6000), slice(0, 12000)),
          ('1', slice(6000, 10000), slice(12000, 20000)),
          ('2', slice(0, 100), slice(0, 0))]


def write(module, path, convert):
    fragments, alleles = tables()
    writer = module.Writer(path)
    for chromosome, f_rows, a_rows in CHUNKS:
        writer.write(chromosome, convert(fragments.iloc[f_rows]),
                     convert(alleles.iloc[a_rows]))
    writer.close()
    return path


@pytest.fixture
def stores(tmp_path):
    return {
        'jax': write(jax_seqdataio, str(tmp_path / 'jax.h5'), lambda t: t),
        'port_h5': write(seqdataio, str(tmp_path / 'port.h5'), as_table),
        'port_dir': write(seqdataio, str(tmp_path / 'port'), as_table),
    }


def assert_same(got, ref, label):
    """Two tables (port Tables or pandas frames) with the same columns and
    values."""
    got_columns = list(got.columns)
    assert got_columns == list(ref.columns), label
    assert len(got) == len(ref), label
    for name in got_columns:
        a = got[name] if isinstance(got, Table) else got[name].values
        b = ref[name] if isinstance(ref, Table) else ref[name].values
        np.testing.assert_array_equal(a, b, err_msg='{} {}'.format(label,
                                                                   name))


def reads(module, path, chromosome, chunksize=None):
    out = {'alleles': module.read_allele_data(path, chromosome,
                                              chunksize=chunksize)}
    for k, filters in enumerate(FILTERS):
        out['fragments {}'.format(k)] = module.read_fragment_data(
            path, chromosome, chunksize=chunksize, **filters)
    if chunksize is not None:
        out = {k: list(v) for k, v in out.items()}
    return out


@pytest.mark.parametrize('chunksize', [None, 3000, 20000])
@pytest.mark.parametrize('chromosome', ['1', '2', 'MT'])
@pytest.mark.parametrize('reader,writer', [
    ('jax', 'port_h5'), ('port', 'jax'), ('port', 'port_dir'),
    ('port', 'port_h5')])
def test_reads_match(stores, reader, writer, chromosome, chunksize):
    """Each package reads the other's file; the port's directory form
    reads as the JAX file; chunked reads come in the JAX package's
    chunks."""
    module = jax_seqdataio if reader == 'jax' else seqdataio
    got = reads(module, stores[writer], chromosome, chunksize)
    ref = reads(jax_seqdataio, stores['jax'], chromosome, chunksize)
    for key in ref:
        label = '{} {} {}'.format(writer, chromosome, key)
        if chunksize is None:
            assert_same(got[key], ref[key], label)
        else:
            assert len(got[key]) == len(ref[key]), label
            for a, b in zip(got[key], ref[key]):
                assert_same(a, b, label)
    assert module.read_chromosomes(stores[writer]) == {'1', '2'}


def test_missing_chromosome_is_the_empty_schema(stores):
    for path in (stores['port_h5'], stores['port_dir']):
        empty = seqdataio.read_fragment_data(path, 'MT')
        assert empty.columns == ['fragment_id', 'start', 'end'] and \
            len(empty) == 0


@pytest.mark.parametrize('out_form', ['h5', 'directory'])
def test_merge_matches_jax(tmp_path, out_form):
    """Per-chromosome stores, one with an empty allele table, merged."""
    fragments, alleles = tables(seed=1, n=500)
    parts = {'1': (slice(0, 300), slice(0, 600)),
             '2': (slice(300, 500), slice(0, 0))}
    jax_parts, port_parts = {}, {}
    for chromosome, (f_rows, a_rows) in parts.items():
        for module, convert, names, suffix in (
                (jax_seqdataio, lambda t: t, jax_parts, '.h5'),
                (seqdataio, as_table, port_parts,
                 '.h5' if chromosome == '1' else '')):
            path = str(tmp_path / '{}_{}{}'.format(
                module.__name__.split('.')[0], chromosome, suffix))
            writer = module.Writer(path)
            writer.write(chromosome, convert(fragments.iloc[f_rows]),
                         convert(alleles.iloc[a_rows]))
            writer.close()
            names[chromosome] = path
    ref_path = str(tmp_path / 'jax_merged.h5')
    jax_seqdataio.merge_seqdata(ref_path, jax_parts)
    path = str(tmp_path / ('merged.h5' if out_form == 'h5' else 'merged'))
    seqdataio.merge_seqdata(path, port_parts)
    assert seqdataio.read_chromosomes(path) == {'1', '2'}
    for chromosome in parts:
        got, ref = (reads(seqdataio, path, chromosome),
                    reads(jax_seqdataio, ref_path, chromosome))
        for key in ref:
            assert_same(got[key], ref[key], '{} {}'.format(chromosome, key))
    assert len(seqdataio.read_allele_data(path, '2')) == 0
    # the port's merged file is read by the JAX package
    if out_form == 'h5':
        for chromosome in parts:
            assert_same(jax_seqdataio.read_fragment_data(path, chromosome),
                        jax_seqdataio.read_fragment_data(ref_path,
                                                         chromosome),
                        chromosome)


def test_store_name_follows_h5py():
    """Where h5py is installed, the workflows' seqdata stores are HDF5."""
    from remixt_tpu_torch.io.store import store_name
    assert store_name('a/sample_t') == 'a/sample_t.h5'
