"""The reference dataset's build: the directory that ``run`` reads.

Counterpart of ``remixt_tpu/ref_data.py``: the Ensembl genome FASTA
concatenated from its assemblies, the UCSC gap table, the genome's bwa and
samtools indexes, and the 1000 Genomes SNP panel (GRCh37: the impute2
tarball and its legends; GRCh38: the phased VCFs converted to BCF, and the
genetic maps), each step run once under its sentinel file, in the JAX
order and under the JAX step names. Downloads go through the ``wget``
tool, the indexes through ``bwa``, ``samtools``, ``bcftools`` and ``tar``.
No pandas: the gap table is rewritten as text.
"""

import csv
import gzip
import os
import subprocess

import remixt_tpu_torch.config
import remixt_tpu_torch.utils
from remixt_tpu_torch.io.table import NA_FIELDS

NUCLEOTIDES = ('A', 'C', 'T', 'G')


def _execute(*args):
    subprocess.check_call([str(a) for a in args])


def _iter_bcf_snps(bcf_filename):
    """Yield (chrom, pos, ref, alt) of every alt allele of a BCF.

    The JAX function reads through pysam where it is installed; neither
    machine the port runs on has it, so this reads ``bcftools view -H``'s
    text, the JAX function's other route."""
    with subprocess.Popen(['bcftools', 'view', '-H', bcf_filename],
                          stdout=subprocess.PIPE, text=True) as out:
        for line in out.stdout:
            fields = line.split('\t')
            chrom, pos, ref, alts = (fields[0], int(fields[1]), fields[3],
                                     fields[4])
            for alt in alts.split(','):
                yield chrom, pos, ref, alt
    if out.returncode != 0:
        raise subprocess.CalledProcessError(
            out.returncode, ['bcftools', 'view', '-H', bcf_filename])


def strip_gap_table_prefix(gap_filename):
    """Drop the ``chr`` of the chromosome column (the second) of a gzipped
    UCSC gap table in place; the other fields are kept as text, with
    pandas' missing-value markers written empty, as the JAX step's
    ``dtype=str`` round trip writes them."""
    with gzip.open(gap_filename, 'rt', newline='') as f:
        rows = [row for row in csv.reader(f, delimiter='\t') if row]
    if not all(row[1].startswith('chr') for row in rows):
        raise ValueError('gap table chromosome names lack the chr prefix')
    with gzip.open(gap_filename, 'wt', newline='') as f:
        out = csv.writer(f, delimiter='\t', lineterminator='\n')
        for row in rows:
            row[1] = row[1][3:]
            out.writerow(['' if field in NA_FIELDS else field
                          for field in row])


def create_ref_data(config, ref_data_dir, ref_data_sentinal,
                    bwa_index_genome=False):
    """Build the reference dataset in ``ref_data_dir`` for the config's
    ``ensembl_genome_version`` (GRCh37 or GRCh38; ValueError otherwise),
    resuming past the steps whose sentinels exist; touches
    ``ref_data_sentinal`` at the end."""
    os.makedirs(ref_data_dir, exist_ok=True)

    auto_sentinal = remixt_tpu_torch.utils.AutoSentinal(
        ref_data_dir + '/sentinal.')

    temp_directory = os.path.join(ref_data_dir, 'tmp')
    os.makedirs(temp_directory, exist_ok=True)

    def get_param(name):
        return remixt_tpu_torch.config.get_param(config, name)

    def get_filename(name, **kwargs):
        return remixt_tpu_torch.config.get_filename(
            config, ref_data_dir, name, **kwargs)

    def wget_genome_fasta():
        chr_name_prefix = get_param('chr_name_prefix')
        with open(get_filename('genome_fasta'), 'w') as genome_file:
            for assembly in get_param('ensembl_assemblies'):
                assembly_url = get_filename('ensembl_assembly_url',
                                            ensembl_assembly=assembly)
                assembly_fasta = os.path.join(
                    temp_directory, 'dna.assembly.{0}.fa'.format(assembly))
                if not os.path.exists(assembly_fasta):
                    remixt_tpu_torch.utils.wget_gunzip(assembly_url,
                                                       assembly_fasta)
                with open(assembly_fasta, 'r') as assembly_file:
                    for line in assembly_file:
                        if line[0] == '>':
                            chromosome_name = line[1:].split()[0]
                            if chr_name_prefix == 'chr':
                                chromosome_name = 'chr' + chromosome_name
                            line = '>' + chromosome_name + '\n'
                        genome_file.write(line)
    auto_sentinal.run(wget_genome_fasta)

    def wget_gap_table():
        prefix = get_param('chr_name_prefix')
        if prefix not in ('', 'chr'):
            raise ValueError(f'unrecognized chr_name_prefix {prefix!r}')

        gap_filename = get_filename('gap_table')
        remixt_tpu_torch.utils.wget(get_filename('gap_url'), gap_filename)

        # UCSC gap tables name chromosomes chr-prefixed; a build of bare
        # names (Ensembl's) has the prefix stripped in place
        if prefix == '':
            strip_gap_table_prefix(gap_filename)
    auto_sentinal.run(wget_gap_table)

    if bwa_index_genome:
        def bwa_index():
            _execute('bwa', 'index', get_filename('genome_fasta'))
        auto_sentinal.run(bwa_index)

    def samtools_faidx():
        _execute('samtools', 'faidx', get_filename('genome_fasta'))
    auto_sentinal.run(samtools_faidx)

    genome_version = get_param('ensembl_genome_version')

    if genome_version == 'GRCh37':
        def wget_thousand_genomes():
            tar_filename = os.path.join(temp_directory,
                                        'thousand_genomes_download.tar.gz')
            remixt_tpu_torch.utils.wget(
                get_param('thousand_genomes_impute_url'), tar_filename)
            _execute('tar', '-C', ref_data_dir, '-xzvf', tar_filename)
            os.remove(tar_filename)
        auto_sentinal.run(wget_thousand_genomes)

        def create_snp_positions():
            with open(get_filename('snp_positions'), 'w') as snp_file:
                for chromosome in remixt_tpu_torch.config.get_chromosomes(
                        config, ref_data_dir):
                    phased_chromosome = chromosome
                    if chromosome == 'X':
                        phased_chromosome = get_param('phased_chromosome_x')
                    legend_filename = get_filename(
                        'legend', chromosome=phased_chromosome)
                    with gzip.open(legend_filename, 'rt') as legend_file:
                        for line in legend_file:
                            if line.startswith('id'):
                                continue
                            row = line.split()
                            position, a0, a1 = row[1], row[2], row[3]
                            if len(a0) != 1 or len(a1) != 1:
                                continue
                            snp_file.write('\t'.join(
                                [chromosome, position, a0, a1]) + '\n')
        auto_sentinal.run(create_snp_positions)

    elif genome_version == 'GRCh38':
        def panel_files(name):
            """(chromosome, the file ``name`` of its panel) over
            ``grch38_1kg_chromosomes``; X's under its own template."""
            x = get_param('grch38_1kg_phased_chromosome_x')
            for chromosome in get_param('grch38_1kg_chromosomes'):
                if chromosome == x:
                    yield chromosome, get_filename(
                        'grch38_1kg_X_' + name + '_filename')
                else:
                    yield chromosome, get_filename(
                        'grch38_1kg_' + name + '_filename',
                        chromosome=chromosome)

        def wget_thousand_genomes():
            x = get_param('grch38_1kg_phased_chromosome_x')
            for chromosome, vcf_filename in panel_files('vcf'):
                if chromosome == x:
                    vcf_url = get_param('grch38_1kg_X_vcf_url')
                else:
                    vcf_url = get_filename('grch38_1kg_vcf_url',
                                           chromosome=chromosome)
                remixt_tpu_torch.utils.wget(vcf_url, vcf_filename)
        auto_sentinal.run(wget_thousand_genomes)

        def convert_bcf():
            for (_, vcf_filename), (_, bcf_filename) in zip(
                    panel_files('vcf'), panel_files('bcf')):
                _execute('bcftools', 'view', '-O', 'b', vcf_filename,
                         '-o', bcf_filename)
                _execute('bcftools', 'index', bcf_filename)
        auto_sentinal.run(convert_bcf)

        def create_snp_positions():
            chr_name_prefix = get_param('chr_name_prefix')
            with open(get_filename('snp_positions'), 'w') as snp_file:
                for _, bcf_filename in panel_files('bcf'):
                    for chrom, coord, ref, alt in _iter_bcf_snps(
                            bcf_filename):
                        if chr_name_prefix == '':
                            if not chrom.startswith('chr'):
                                raise ValueError('{} names chromosome {!r} '
                                                 'without the chr prefix'
                                                 .format(bcf_filename, chrom))
                            chrom = chrom[3:]
                        elif chr_name_prefix != 'chr':
                            raise ValueError('unrecognized chr_name_prefix '
                                             f'{chr_name_prefix}')
                        if ref not in NUCLEOTIDES or alt not in NUCLEOTIDES:
                            continue
                        snp_file.write('{}\t{}\t{}\t{}\n'.format(
                            chrom, coord, ref, alt))
        auto_sentinal.run(create_snp_positions)

        def get_genetic_maps():
            tar_filename = os.path.join(temp_directory,
                                        'genetic_maps.b38.tar.gz')
            remixt_tpu_torch.utils.wget(get_param('genetic_maps_grch38_url'),
                                        tar_filename)
            _execute('tar', '-C', ref_data_dir, '-xzvf', tar_filename)
            os.remove(tar_filename)
        auto_sentinal.run(get_genetic_maps)

    else:
        raise ValueError('unsupported genome version ' + genome_version)

    with open(ref_data_sentinal, 'w'):
        pass
