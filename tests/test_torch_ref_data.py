"""The port's reference build (``create_ref_data``) against the JAX
package's, on the CPU, through the stand-in tools of
``chip_smoke.write_standin_tools`` first on the PATH (their ``wget``
copies from a local mirror directory).

GRCh37: ``chip_smoke.make_read_fixture``'s reference at a small size (two
chromosomes of 300 and 200 kb with their impute2 panel), written into the
mirror as its upstream sources (``write_read_mirror``). GRCh38: phase 14's
mirror (``write_refbuild_mirror``: three chromosomes of 120-240 kb, their
VCFs and genetic maps). Both packages build from the same mirror; every
file of the two directories must be equal (a .gz file compared
decompressed), the sentinels included.

Run as a script, ``python tests/test_torch_ref_data.py --phase14 WORKDIR``
builds phase 14's reference with the JAX package and prints the digest
that ``chip_smoke.py`` holds in ``REFBUILD_JAX['create_ref_data']``.
"""

import argparse
import importlib
import importlib.util
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import remixt_tpu.ref_data as jax_ref_data  # noqa: E402
import remixt_tpu.ui.create_ref_data as jax_create_ref_data  # noqa: E402
from remixt_tpu_torch import config as config_mod  # noqa: E402
from remixt_tpu_torch.ui import main as cli  # noqa: E402

GRCH37_CHROMOSOMES = {'1': 300000, '2': 200000}
SENTINELS = {
    'GRCh37': ['wget_genome_fasta', 'wget_gap_table', 'bwa_index',
               'samtools_faidx', 'wget_thousand_genomes',
               'create_snp_positions'],
    'GRCh38': ['wget_genome_fasta', 'wget_gap_table', 'bwa_index',
               'samtools_faidx', 'wget_thousand_genomes', 'convert_bcf',
               'create_snp_positions', 'get_genetic_maps']}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def cs():
    return chip_smoke()


@pytest.fixture(scope='module')
def mirrors(cs, tmp_path_factory):
    """{genome version: (mirror directory, the build's config)}."""
    root = tmp_path_factory.mktemp('mirrors')
    fixture = cs.make_read_fixture(str(root / 'fixture'), GRCH37_CHROMOSOMES,
                                   0.05, N=10)
    grch37 = str(root / 'grch37')
    cs.write_read_mirror(fixture['ref_data_dir'], 'GRCh37', grch37)
    grch38 = str(root / 'grch38')
    cs.write_refbuild_mirror(grch38)
    return {'GRCh37': (grch37, cs.build_config('GRCh37', GRCH37_CHROMOSOMES)),
            'GRCh38': (grch38, cs.refbuild_config('unused', 'unused'))}


@pytest.fixture
def tools(cs, tmp_path, monkeypatch):
    """A function giving the stand-ins' bin directory, serving the mirror
    of a genome version, first on the PATH."""
    def put(mirror):
        bin_dir = cs.write_standin_tools(str(tmp_path / 'bin'), mirror)
        monkeypatch.setenv('PATH', bin_dir + os.pathsep + os.environ['PATH'])
        cs.check_standin_wget(bin_dir)
        return bin_dir
    return put


def write_config(path, config):
    with open(path, 'w') as f:
        json.dump(config, f)
    return path


def jax_build(tmp_path, config, name='jax'):
    ref_dir = str(tmp_path / name)
    jax_create_ref_data.run(
        ref_data_dir=ref_dir, bwa_index_genome=True,
        config=write_config(str(tmp_path / (name + '.yaml')), config))
    return ref_dir


def port_build(tmp_path, config, name='port'):
    ref_dir = str(tmp_path / name)
    cli.main(['create_ref_data', ref_dir, '--config',
              write_config(str(tmp_path / (name + '.yaml')), config),
              '--bwa_index_genome'])
    return ref_dir


def sentinels(ref_dir):
    return sorted(name[len('sentinal.'):] for name in os.listdir(ref_dir)
                  if name.startswith('sentinal.'))


@pytest.mark.parametrize('version', ['GRCh37', 'GRCh38'])
def test_create_ref_data_matches_jax(cs, mirrors, tools, tmp_path, version):
    mirror, config = mirrors[version]
    tools(mirror)
    jax_dir = jax_build(tmp_path, config)
    port_dir = port_build(tmp_path, config)
    want = cs.tree_digest(jax_dir)
    assert cs.tree_digest(port_dir) == want
    assert sentinels(port_dir) == sorted(SENTINELS[version])
    assert os.path.exists(os.path.join(port_dir, 'sentinal'))
    snps = config_mod.get_filename(config, port_dir, 'snp_positions')
    with open(snps) as f:
        rows = [line.rstrip('\n').split('\t') for line in f]
    assert rows and all(len(row) == 4 and row[0] in config['chromosomes']
                        for row in rows)


def test_grch37_build_is_write_references(cs, mirrors, tools, tmp_path):
    """Phase 12's build: the port's reference equals the one
    ``write_reference`` wrote, and the run's config points at it."""
    fixture = cs.make_read_fixture(str(tmp_path / 'fixture'),
                                   GRCH37_CHROMOSOMES, 0.05, N=10)
    mirror = str(tmp_path / 'mirror')
    bin_dir = tools(mirror)
    built = str(tmp_path / 'built')
    made = cs.build_read_reference('test', fixture, GRCH37_CHROMOSOMES,
                                   built, bin_dir, mirror)
    assert made['ref_data_dir'] == built
    with open(fixture['config_file']) as f:
        run_config = json.load(f)
    assert run_config == made['config']
    assert run_config['mappability_filename'] == \
        fixture['config']['mappability_filename']
    assert config_mod.get_filename(run_config, built, 'genome_fasta') == \
        os.path.join(built, 'Homo_sapiens.GRCh37.75.dna.chromosomes.fa')
    for chrom in GRCH37_CHROMOSOMES:
        assert cs.same_file(cs.panel_truth_path(built, chrom),
                            cs.panel_truth_path(fixture['ref_data_dir'],
                                                chrom))
    assert [name for name, _, ran in made['build_steps'] if ran] == \
        SENTINELS['GRCh37']
    with open(os.path.join(bin_dir, cs.STANDIN_CALLS)) as f:
        tools_called = [line.split()[0] for line in f]
    assert tools_called == ['wget', 'wget', 'wget', 'bwa', 'samtools',
                            'wget']


def test_chr_name_prefix_chr(cs, mirrors, tools, tmp_path):
    mirror, config = mirrors['GRCh38']
    tools(mirror)
    config = dict(config, chr_name_prefix='chr',
                  chromosomes=['chr' + c for c in config['chromosomes']])
    port_dir = port_build(tmp_path, config)
    assert cs.tree_digest(port_dir) == cs.tree_digest(
        jax_build(tmp_path, config))
    with open(config_mod.get_filename(config, port_dir, 'genome_fasta')) as f:
        assert f.readline() == '>chr1\n'
    assert cs.same_file(config_mod.get_filename(config, port_dir,
                                                'gap_table'),
                        os.path.join(mirror, 'gap.txt.gz'))
    with open(config_mod.get_filename(config, port_dir,
                                      'snp_positions')) as f:
        assert f.readline().startswith('chr1\t')


def test_second_run_calls_no_tool(cs, mirrors, tools, tmp_path):
    mirror, config = mirrors['GRCh38']
    bin_dir = tools(mirror)
    port_dir = port_build(tmp_path, config)
    first = cs.tree_digest(port_dir)
    assert len(cs.tool_calls(bin_dir)) > 0
    port_build(tmp_path, config)
    assert cs.tool_calls(bin_dir) == []
    assert cs.tree_digest(port_dir) == first


@pytest.mark.parametrize('step, removed, called', [
    ('samtools_faidx', ['Homo_sapiens.GRCh38.93.dna.chromosomes.fa.fai'],
     ['samtools']),
    ('create_snp_positions', ['thousand_genomes_snps.tsv'],
     ['bcftools'] * 3),
    ('get_genetic_maps', ['chr1.b38.gmap.gz', 'chr2.b38.gmap.gz',
                          'chrX.b38.gmap.gz'], ['wget'])])
def test_removing_a_sentinel_reruns_that_step_alone(
        cs, mirrors, tools, tmp_path, step, removed, called):
    mirror, config = mirrors['GRCh38']
    bin_dir = tools(mirror)
    port_dir = port_build(tmp_path, config)
    first = cs.tree_digest(port_dir)
    cs.tool_calls(bin_dir)
    os.remove(os.path.join(port_dir, 'sentinal.' + step))
    for name in removed:
        os.remove(os.path.join(port_dir, name))
    with cs.timed_steps() as steps:
        port_build(tmp_path, config)
    assert [name for name, _, ran in steps if ran] == [step]
    assert [call.split()[0] for call in cs.tool_calls(bin_dir)] == called
    assert cs.tree_digest(port_dir) == first


def test_a_missing_mirror_file_fails_the_step(cs, mirrors, tools, tmp_path):
    """The wget stand-in fails for a URL the mirror lacks, and the step
    fails with it: no sentinel, no fallback."""
    mirror, config = mirrors['GRCh38']
    tools(mirror)
    config = dict(config, gap_url_template='http://localhost/missing.txt.gz')
    with pytest.raises(Exception) as error:
        port_build(tmp_path, config)
    assert 'wget' in str(error.value)
    port_dir = str(tmp_path / 'port')
    assert sentinels(port_dir) == ['wget_genome_fasta']


@pytest.mark.parametrize('override', [
    dict(chr_name_prefix='x'),
    dict(ensembl_genome_version='GRCh36', ensembl_assembly_url_template=(
        'ftp://ftp.ensembl.org/Homo_sapiens.GRCh38.dna.{ensembl_assembly}'
        '.fa.gz'))],
    ids=['prefix', 'genome_version'])
def test_unknown_prefix_or_genome_version_raises(mirrors, tools, tmp_path,
                                                 override):
    mirror, config = mirrors['GRCh38']
    tools(mirror)
    config = dict(config, **override)
    with pytest.raises(ValueError):
        jax_build(tmp_path, config)
    with pytest.raises(ValueError):
        port_build(tmp_path, config)
    assert sentinels(str(tmp_path / 'port')) == \
        sentinels(str(tmp_path / 'jax'))


def parser_options(module):
    parser = argparse.ArgumentParser()
    module.add_arguments(parser)
    return [(action.option_strings, action.dest, action.default,
             action.required, action.type, action.nargs,
             type(action).__name__) for action in parser._actions]


@pytest.mark.parametrize('name', ['create_ref_data', 'mappability_bwa'])
def test_parsers_have_the_jax_options(name):
    port = importlib.import_module('remixt_tpu_torch.ui.' + name)
    jax = importlib.import_module('remixt_tpu.ui.' + name)
    assert parser_options(port) == parser_options(jax)
    assert cli.MODULES[name] is port


def phase14_create_ref_data(workdir):
    """The JAX package's ``create_ref_data`` on phase 14's mirror, through
    the stand-ins; returns the directory's digest."""
    cs = chip_smoke()
    mirror = os.path.join(workdir, 'mirror')
    cs.fresh_directory(workdir)
    cs.write_refbuild_mirror(mirror)
    bin_dir = cs.write_standin_tools(os.path.join(workdir, 'bin'), mirror)
    built = os.path.join(workdir, 'built')
    config = cs.refbuild_config(built, 'unused')
    with cs.first_on_path(bin_dir):
        cs.check_standin_wget(bin_dir)
        jax_ref_data.create_ref_data(config, built,
                                     os.path.join(built, 'sentinal'),
                                     bwa_index_genome=True)
    return cs.tree_digest(built)


def test_phase14_create_ref_data_digest(cs, tmp_path):
    """The script mode's digest is ``REFBUILD_JAX``'s."""
    assert phase14_create_ref_data(str(tmp_path / 'work')) == \
        cs.REFBUILD_JAX['create_ref_data']


if __name__ == '__main__':
    parser = argparse.ArgumentParser(
        usage='python tests/test_torch_ref_data.py --phase14 WORKDIR')
    parser.add_argument('--phase14', metavar='WORKDIR', required=True)
    args = parser.parse_args()
    print('REFBUILD_JAX = dict(create_ref_data=' + repr(
        phase14_create_ref_data(args.phase14)) + ')')
