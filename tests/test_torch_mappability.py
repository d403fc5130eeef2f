"""The port's mappability build (``mappability/tasks.py``,
``mappability/bwa/workflow.py`` and the ``mappability_bwa`` subcommand)
against the JAX package's, on the CPU, function by function on the same
files, with the stand-in ``bwa`` of ``chip_smoke.write_standin_tools``
(an exact forward-strand aligner: a k-mer that occurs once in the genome
at its origin with MAPQ 60, a repeated one at its first occurrence with
MAPQ 0). Text outputs must be equal byte for byte, stores array by array.

The JAX functions raise on three inputs where the port writes empty
output: a chunk of alignments with no alignment line (AttributeError),
one with no k-mer realigned at its origin (IndexError), and no shards to
merge (ValueError). Each has a test that shows both.

Run as a script, ``python tests/test_torch_mappability.py --phase14
WORKDIR`` makes phase 14's mappability store with the JAX package's
tasks (its reference built by the JAX ``create_ref_data``), chunk by chunk
as the workflow does, leaving out the chunks on which the JAX
``create_bedgraph`` raises (those wholly in the planted repeat's second
copy, where no k-mer realigns at its origin), and prints what
``chip_smoke.py`` holds in ``REFBUILD_JAX['mappability']`` and
``REFBUILD_JAX['empty_chunks']``.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import remixt_tpu.analysis.gcbias as jax_gcbias  # noqa: E402
import remixt_tpu.mappability.bwa.workflow as jax_workflow  # noqa: E402
import remixt_tpu.mappability.tasks as jax_tasks  # noqa: E402
import remixt_tpu.ui.mappability_bwa as jax_mappability_bwa  # noqa: E402
from remixt_tpu_torch import config as config_mod  # noqa: E402
from remixt_tpu_torch.analysis import gcbias  # noqa: E402
from remixt_tpu_torch.mappability import tasks  # noqa: E402
from remixt_tpu_torch.mappability.bwa import workflow  # noqa: E402
from remixt_tpu_torch.ui import main as cli  # noqa: E402

# the SAM of tests/test_prep.py's bedgraph test, then rows it lacks: a
# chromosome whose name holds ':', chromosomes that sort as text ('10'
# before '2'), an unmapped row, secondary rows at the origin (one beside
# a primary row at the same position) and away from it
SAM_ROWS = [
    '@SQ\tSN:1\tLN:100',
    '1:0\t0\t1\t1\t60\t5M',
    '1:1\t0\t1\t2\t60\t5M',
    '1:2\t0\t1\t3\t60\t5M',
    '1:3\t0\t1\t4\t10\t5M',
    '1:5\t0\t1\t6\t60\t5M',
    '1:7\t0\t1\t9\t60\t5M',
    '2:0\t0\t2\t1\t60\t5M',
    '10:4\t0\t10\t5\t60\t5M\t*\t0\t0\tACGTA\t*',
    '10:5\t0\t10\t6\t60\t5M\t*\t0\t0\tCGTAC\t*',
    'HLA:A:3\t0\tHLA:A\t4\t60\t5M',
    '1:8\t4\t*\t0\t0\t*\t*\t0\t0\tACGTA\t*',
    '1:4\t256\t1\t5\t0\t5M',
    '1:1\t256\t1\t2\t0\t5M',
    '1:6\t256\t2\t7\t0\t5M',
    '2:1\t0\t2\t2\t60\t5M',
]


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def cs():
    return chip_smoke()


def read_bytes(path):
    with open(path, 'rb') as f:
        return f.read()


def write_lines(path, rows):
    with open(path, 'w') as f:
        f.write('\n'.join(rows) + '\n')
    return path


def write_genome(path, seed, lengths, width=60):
    """A FASTA from a seed: mixed case, runs of N, a repeat, and the
    records of ``lengths`` (one shorter than any k)."""
    rng = np.random.RandomState(seed)
    with open(path, 'w') as f:
        for i, (name, length) in enumerate(lengths.items()):
            bases = np.array(list('ACGTacgt'))[rng.randint(0, 8, length)]
            if length > 400:
                bases[100:130] = 'N'
                bases[200:205] = 'n'
                bases[300:360] = bases[10:70]
            f.write('>{} description {}\n'.format(name, i))
            sequence = ''.join(bases)
            f.writelines(sequence[p:p + width] + '\n'
                         for p in range(0, length, width))
    return path


@pytest.mark.parametrize('k', [3, 10, 100])
def test_create_kmers_matches_jax(tmp_path, k):
    genome = write_genome(str(tmp_path / 'genome.fa'), 3, {
        '1': 2500, '2': 1000, 'short': 7, 'exact': 10, 'n_only': 0})
    with open(genome, 'a') as f:
        f.write('>gap\nNNNNNNNNNNNNNNNNNNNNNNNN\nnnnnnnnn\n')
    jax_tasks.create_kmers(genome, k, str(tmp_path / 'jax.fa'))
    tasks.create_kmers(genome, k, str(tmp_path / 'port.fa'))
    jax, port = (read_bytes(str(tmp_path / name))
                 for name in ('jax.fa', 'port.fa'))
    assert port == jax and len(port) > 0


@pytest.mark.parametrize('lines_per_file', [1, 3, 4, 20])
def test_split_file_byline_matches_jax(tmp_path, lines_per_file):
    source = str(tmp_path / 'in.txt')
    with open(source, 'w') as f:
        f.write(''.join('line{}\n'.format(i) for i in range(9)) + 'last')

    def shards(module, prefix):
        names = []

        def namer(i):
            names.append(str(tmp_path / '{}{}.txt'.format(prefix, i)))
            return names[-1]
        module.split_file_byline(source, lines_per_file, namer)
        return [read_bytes(name) for name in names]

    port = shards(tasks, 'port')
    assert port == shards(jax_tasks, 'jax')
    assert len(port) == -(-10 // lines_per_file)


def test_create_bedgraph_matches_jax(tmp_path):
    sam = write_lines(str(tmp_path / 'aln.sam'), SAM_ROWS)
    jax_tasks.create_bedgraph(sam, str(tmp_path / 'jax.tsv'))
    tasks.create_bedgraph(sam, str(tmp_path / 'port.tsv'))
    port = read_bytes(str(tmp_path / 'port.tsv'))
    assert port == read_bytes(str(tmp_path / 'jax.tsv'))
    assert port.decode().splitlines() == [
        '1\t0\t2\t60', '1\t1\t2\t0', '1\t2\t3\t60', '1\t3\t4\t10',
        '1\t4\t5\t0', '1\t5\t6\t60', '10\t4\t6\t60', '2\t0\t2\t60',
        'HLA:A\t3\t4\t60']


def bedgraph_shards(tmp_path):
    """{key: bedgraph} of three chunks of alignments, in a key order that
    is not the sorted one."""
    rows = SAM_ROWS[1:]
    shards = {}
    for key, part in ((2, rows[10:]), (0, rows[:6]), (1, rows[6:10])):
        sam = write_lines(str(tmp_path / 'aln{}.sam'.format(key)), part)
        shards[key] = str(tmp_path / 'bedgraph{}.tsv'.format(key))
        tasks.create_bedgraph(sam, shards[key])
    return shards


def test_merge_files_by_line_matches_jax(cs, tmp_path):
    """The .h5 store dataset by dataset, the directory through
    ``read_mappability_indicator``; an empty shard adds nothing."""
    shards = bedgraph_shards(tmp_path)
    jax_store = str(tmp_path / 'jax.h5')
    jax_tasks.merge_files_by_line(shards, jax_store)
    empty = str(tmp_path / 'empty.tsv')
    open(empty, 'w').close()
    with_empty = dict(shards, empty=empty)
    port_h5, port_dir = str(tmp_path / 'port.h5'), str(tmp_path / 'port')
    tasks.merge_files_by_line(with_empty, port_h5)
    tasks.merge_files_by_line(with_empty, port_dir)
    with h5py.File(jax_store, 'r') as jax, h5py.File(port_h5, 'r') as port:
        assert sorted(port) == sorted(jax) == [
            'chromosome_1', 'chromosome_10', 'chromosome_2',
            'chromosome_HLA:A']
        for group in jax:
            for column in tasks.STORE_COLUMNS:
                want, got = jax[group][column], port[group][column]
                assert got.dtype == want.dtype == np.int64
                assert got.compression == want.compression
                assert got.compression_opts == want.compression_opts
                np.testing.assert_array_equal(got[()], want[()])
    assert cs.store_digest(port_dir) == cs.store_digest(jax_store)
    for chrom in ('1', '10', '2', 'HLA:A'):
        for threshold in (1, 30, 60):
            want = jax_gcbias.read_mappability_indicator(jax_store, chrom, 12,
                                                         threshold)
            np.testing.assert_array_equal(
                gcbias.read_mappability_indicator(port_dir, chrom, 12,
                                                  threshold), want)


def no_origin_true(tmp_path, module, out):
    sam = write_lines(str(tmp_path / 'away.sam'), [
        '@SQ\tSN:1\tLN:100', '1:5\t0\t1\t10\t60\t5M',
        '1:6\t0\t2\t7\t0\t5M'])
    module.create_bedgraph(sam, out)


def no_alignment_line(tmp_path, module, out):
    sam = write_lines(str(tmp_path / 'header.sam'), [
        '@HD\tVN:1.6', '@SQ\tSN:1\tLN:100'])
    module.create_bedgraph(sam, out)


def no_shards(tmp_path, module, out):
    module.merge_files_by_line({}, out)


@pytest.mark.parametrize('make, name, error', [
    (no_origin_true, 'bedgraph.tsv', IndexError),
    (no_alignment_line, 'bedgraph.tsv', AttributeError),
    (no_shards, 'store.h5', ValueError),
    (no_shards, 'store', ValueError)],
    ids=['no_origin_true', 'no_alignment_line', 'no_shards_h5',
         'no_shards_directory'])
def test_defect_inputs_give_empty_output(tmp_path, make, name, error):
    """The JAX function raises; the port writes an empty bedgraph or an
    empty store."""
    jax_out = str(tmp_path / ('jax_' + name))
    with pytest.raises(error):
        make(tmp_path, jax_tasks, jax_out)
    out = str(tmp_path / name)
    make(tmp_path, tasks, out)
    if name.endswith('.tsv'):
        assert read_bytes(out) == b''
    elif name.endswith('.h5'):
        with h5py.File(out, 'r') as store:
            assert list(store) == []
    else:
        assert os.listdir(out) == []
    assert not os.path.exists(out + '.partial')


@pytest.fixture
def standins(cs, tmp_path, monkeypatch):
    bin_dir = cs.write_standin_tools(str(tmp_path / 'bin'))
    monkeypatch.setenv('PATH', bin_dir + os.pathsep + os.environ['PATH'])
    return bin_dir


def test_mappability_bwa_matches_jax(cs, tmp_path, monkeypatch, standins):
    """The whole workflow through ``ui.main`` in several chunks (none
    wholly repeat), into an .h5 and a directory store, against the JAX
    workflow's store; then again, calling no tool."""
    genome = write_genome(str(tmp_path / 'genome.fa'), 5,
                          {'1': 3000, '2': 2200, 'short': 50})
    monkeypatch.setattr(workflow, 'KMERS_PER_CHUNK', 1000)
    monkeypatch.setattr(jax_workflow, 'KMERS_PER_CHUNK', 1000)
    stores = {}
    for name in ('jax.h5', 'port.h5', 'port'):
        config = dict(genome_fasta_filename=genome, mappability_length=20,
                      mappability_filename=str(tmp_path / name))
        config_file = str(tmp_path / (name + '.yaml'))
        with open(config_file, 'w') as f:
            json.dump(config, f)
        ref_dir = str(tmp_path / ('ref_' + name))
        if name.startswith('jax'):
            jax_mappability_bwa.run(ref_data_dir=ref_dir, config=config_file,
                                    tmpdir=None, maxjobs=1)
            chunks = len(cs.tool_calls(standins))
            assert chunks > 5
        else:
            cli.main(['mappability_bwa', ref_dir, '--config', config_file])
            calls = cs.tool_calls(standins)
            assert len(calls) == chunks
            assert all(call.startswith('bwa mem -M ') for call in calls)
            cli.main(['mappability_bwa', ref_dir, '--config', config_file])
            assert cs.tool_calls(standins) == []
        stores[name] = config['mappability_filename']
    want = cs.store_digest(stores['jax.h5'])
    assert cs.store_digest(stores['port.h5']) == want
    assert cs.store_digest(stores['port']) == want
    assert sorted(want) == ['1', '2', 'short']
    for chrom, length in (('1', 3000), ('2', 2200)):
        indicator = gcbias.read_mappability_indicator(stores['port'], chrom,
                                                      length, 1)
        assert 0 < indicator.sum() < length


def test_h5_store_without_h5py_is_refused(tmp_path, monkeypatch, standins):
    """Without h5py an .h5 store is refused at once, naming the store and
    the override, before any file is made."""
    genome = write_genome(str(tmp_path / 'genome.fa'), 5, {'1': 500})
    monkeypatch.setitem(sys.modules, 'h5py', None)
    ref_dir = str(tmp_path / 'ref')
    config = dict(genome_fasta_filename=genome)
    store = config_mod.get_filename(config, ref_dir, 'mappability')
    assert store.endswith('.h5')
    config_file = str(tmp_path / 'config.yaml')
    with open(config_file, 'w') as f:
        json.dump(config, f)
    with pytest.raises(ImportError) as error:
        cli.main(['mappability_bwa', ref_dir, '--config', config_file])
    assert store in str(error.value)
    assert 'mappability_filename' in str(error.value)
    assert not os.path.exists(ref_dir)
    assert not os.path.exists(os.path.join(standins, 'calls.log'))


def phase14_mappability(workdir):
    """Phase 14's mappability store made by the JAX package's tasks on the
    reference its ``create_ref_data`` built, chunk by chunk with the
    stand-in ``bwa``, the chunks on which its ``create_bedgraph`` raises
    left out. Returns dict(mappability: the store's digest, empty_chunks:
    those chunks)."""
    from test_torch_ref_data import phase14_create_ref_data
    cs = chip_smoke()
    phase14_create_ref_data(workdir)
    built, bin_dir = (os.path.join(workdir, name) for name in ('built',
                                                               'bin'))
    genome_fasta = config_mod.get_filename(cs.refbuild_config(built, 'x'),
                                           built, 'genome_fasta')
    tmp = os.path.join(workdir, 'mappability')
    os.makedirs(tmp)
    kmers = os.path.join(tmp, 'kmers.fa')
    jax_tasks.create_kmers(genome_fasta, cs.REFBUILD_K, kmers)
    chunks = []

    def namer(i):
        chunks.append(os.path.join(tmp, 'kmers_chunk_{}.fa'.format(i)))
        return chunks[-1]
    jax_tasks.split_file_byline(kmers, cs.REFBUILD_CHUNK_LINES, namer)
    bedgraphs, empty = {}, []
    with cs.first_on_path(bin_dir):
        for idx, chunk in enumerate(chunks):
            sam = os.path.join(tmp, 'alignments_{}.sam'.format(idx))
            with open(sam, 'w') as out:
                subprocess.check_call(['bwa', 'mem', '-M', genome_fasta,
                                       chunk], stdout=out)
            bedgraph = os.path.join(tmp, 'bedgraph_{}.tsv'.format(idx))
            try:
                jax_tasks.create_bedgraph(sam, bedgraph)
            except IndexError:
                # the JAX defect: no k-mer of the chunk realigned at its
                # origin
                assert len(tasks._origin_true_alignments(sam)[1]) == 0
                empty.append(idx)
                continue
            bedgraphs[idx] = bedgraph
    store = os.path.join(tmp, 'mappability.h5')
    jax_tasks.merge_files_by_line(bedgraphs, store)
    return dict(mappability=cs.store_digest(store), empty_chunks=empty)


def test_phase14_mappability_digest(cs, tmp_path):
    """The script mode's digest is ``REFBUILD_JAX``'s, and a chunk was
    left out."""
    made = phase14_mappability(str(tmp_path / 'work'))
    assert made['mappability'] == cs.REFBUILD_JAX['mappability']
    assert made['empty_chunks'] == cs.REFBUILD_JAX['empty_chunks'] != []


def test_phase14_runs_on_the_cpu(cs, tmp_path):
    """``chip_smoke.py`` phase 14 on this CPU (it is host code only)."""
    made = cs.phase_reference_build('cpu', root=str(tmp_path / 'phase14'))
    assert made == cs.REFBUILD_JAX


if __name__ == '__main__':
    parser = argparse.ArgumentParser(
        usage='python tests/test_torch_mappability.py --phase14 WORKDIR')
    parser.add_argument('--phase14', metavar='WORKDIR', required=True)
    args = parser.parse_args()
    made = phase14_mappability(args.phase14)
    print('REFBUILD_JAX.update(mappability={!r}, empty_chunks={!r})'.format(
        made['mappability'], made['empty_chunks']))
