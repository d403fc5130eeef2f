"""Haplotype inference: SNP genotyping, phasing, block allele counting
(numpy).

Counterpart of ``remixt_tpu/analysis/haplotype.py``:

* genotyping: binomial-posterior calls from the normal, or pooled one-sided
  binomial tail tests across tumours;
* phasing, driven through ``subprocess`` as the JAX package drives it, by
  the genome build (``ensembl_genome_version``):

  - GRCh38: ``shapeit4`` builds a phasing graph of the het SNPs against the
    1000 Genomes high-coverage panel and ``bingraphsample`` draws phasings
    from it, with ``bgzip``, ``tabix`` and ``bcftools``;
  - GRCh37: ``shapeit2`` (the ``shapeit`` binary) builds a haplotype graph
    of the called SNPs against the 1000 Genomes phase 1 impute2 panel
    (legend, haplotypes, sample file and genetic map) and ``shapeit
    -convert`` draws phasings from it;

  the draws' consensus makes confidence-thresholded haplotype blocks;
* block allele counting (one SNP vote per fragment, the first matching
  allele row in seqdata order) and the phasing of blocks into alleles a/b
  across samples.
"""

import os
import subprocess

import numpy as np
import scipy.stats

import remixt_tpu_torch.config
from remixt_tpu_torch import segalg, seqdataio
from remixt_tpu_torch.io.table import Table, read_tsv, write_tsv
from remixt_tpu_torch.simulations.haplotype import read_legend

HAPS_COLUMNS = ['chromosome', 'position', 'allele', 'hap_label', 'allele_id']
ALLELE_COUNT_COLUMNS = ['start', 'end', 'hap_label', 'allele_id',
                        'readcount', 'chromosome']
SEGMENT_KEY = ['chromosome', 'start', 'end']


def _run(*args):
    subprocess.check_call([str(a) for a in args if str(a) != ''])


def _param(config, name):
    return remixt_tpu_torch.config.get_param(config, name)


def _ref_file(config, ref_data_dir, name, **kwargs):
    return remixt_tpu_torch.config.get_filename(config, ref_data_dir, name,
                                                **kwargs)


def _empty(columns, dtype=object):
    return Table([(c, np.array([], dtype=dtype)) for c in columns])


# ---------------------------------------------------------------------------
# SNP genotyping
# ---------------------------------------------------------------------------

def infer_snp_genotype(data, base_call_error=0.005, call_threshold=0.9):
    """Posterior genotype calls from ref/alt counts, added to the Table
    ``data`` in place: total_count, evidence, and per genotype (AA, AB, BB)
    its likelihood, posterior and 0/1 call."""
    alt = data['alt_count']
    total = data['ref_count'] + data['alt_count']
    data['total_count'] = total

    # rows: AA, AB, BB; success probability of the minority allele
    genotypes = ('AA', 'AB', 'BB')
    observed = np.stack([alt, alt, total - alt])
    error_rates = np.array([base_call_error, 0.5, base_call_error])
    likelihood = scipy.stats.binom.pmf(
        observed, total[None, :], error_rates[:, None])
    posterior = likelihood / likelihood.sum(axis=0, keepdims=True)

    data['evidence'] = likelihood.sum(axis=0)
    for row, genotype in enumerate(genotypes):
        data['likelihood_' + genotype] = likelihood[row]
        data['posterior_' + genotype] = posterior[row]
        data[genotype] = (posterior[row] >= call_threshold).astype(np.int64)


def _tally(positions, is_alt):
    """(position, ref_count, alt_count) per distinct position, sorted."""
    unique, inverse = np.unique(positions, return_inverse=True)
    alt = np.bincount(inverse, weights=is_alt, minlength=len(unique))
    total = np.bincount(inverse, minlength=len(unique))
    alt = alt.astype(np.int64)
    return Table([('position', unique.astype(np.int64)),
                  ('ref_count', total - alt), ('alt_count', alt)])


def read_snp_counts(seqdata_filename, chromosome, num_rows=1000000):
    """Ref/alt read counts per SNP position, sorted by position."""
    positions, is_alt = [], []
    for chunk in seqdataio.read_allele_data(seqdata_filename, chromosome,
                                            chunksize=num_rows):
        positions.append(chunk['position'])
        is_alt.append(chunk['is_alt'])
    if not positions or sum(len(p) for p in positions) == 0:
        return _empty(['position', 'ref_count', 'alt_count'], np.int64)
    return _tally(np.concatenate(positions), np.concatenate(is_alt))


def infer_snp_genotype_from_normal(snp_genotype_filename, seqdata_filename,
                                   chromosome, config):
    """Genotypes called from the matched normal sample."""
    counts = read_snp_counts(seqdata_filename, chromosome)
    infer_snp_genotype(counts,
                       _param(config, 'sequencing_base_call_error'),
                       _param(config, 'het_snp_call_threshold'))
    write_tsv(counts.select(['position', 'AA', 'AB', 'BB']),
              snp_genotype_filename)


def infer_snp_genotype_from_tumour(snp_genotype_filename, seqdata_filenames,
                                   chromosome, config):
    """Genotypes pooled across tumour samples: an allele is present when
    its pooled count is an improbably large binomial tail under the base
    call error rate, P(X >= k) = sf(k - 1); positions with at most 50
    reads are dropped."""
    error_rate = _param(config, 'sequencing_base_call_error')
    p_threshold = _param(config, 'homozygous_p_value_threshold')

    counts = [read_snp_counts(filename, chromosome)
              for filename in seqdata_filenames.values()]
    positions = np.concatenate([c['position'] for c in counts])
    unique, inverse = np.unique(positions, return_inverse=True)
    pooled = {col: np.bincount(inverse, weights=np.concatenate(
        [c[col] for c in counts]), minlength=len(unique)).astype(np.int64)
        for col in ('ref_count', 'alt_count')}
    keep = pooled['ref_count'] + pooled['alt_count'] > 50
    n = (pooled['ref_count'] + pooled['alt_count'])[keep]

    present = {}
    for allele, count_col in (('A', 'ref_count'), ('B', 'alt_count')):
        k = pooled[count_col][keep]
        present[allele] = scipy.stats.binom.sf(k - 1, n, error_rate) \
            < p_threshold

    write_tsv(Table([
        ('position', unique[keep].astype(np.int64)),
        ('AA', (present['A'] & ~present['B']).astype(np.int64)),
        ('AB', (present['A'] & present['B']).astype(np.int64)),
        ('BB', (present['B'] & ~present['A']).astype(np.int64)),
    ]), snp_genotype_filename)


# ---------------------------------------------------------------------------
# Haplotype blocks from phasing samples
# ---------------------------------------------------------------------------

def _haplotype_blocks(fraction_changepoint, block_break, threshold):
    """Vectorized block construction from changepoint fractions.

    Args:
        fraction_changepoint: (n,) fraction of phasing samples placing a
            changepoint before each het SNP
        block_break: (n,) bool, positions that must start a new block
            regardless of confidence (chromosome boundaries)
        threshold: confidence below which a block is split

    Returns dict of (n,) arrays: changepoint_confidence, is_changepoint,
    hap_label (0-based), allele1, allele2. A block splits wherever the
    consensus changepoint call is not confident; allele1 alternates at
    each consensus changepoint (parity: reference haplotype.py:276-292).
    """
    frac = np.asarray(fraction_changepoint, dtype=float)
    confidence = np.maximum(frac, 1.0 - frac)
    is_changepoint = np.round(frac).astype(int)
    split = (confidence < float(threshold)) | np.asarray(block_break, bool)
    return {
        'changepoint_confidence': confidence,
        'is_changepoint': is_changepoint,
        'hap_label': np.cumsum(split) - 1,
        'allele1': np.cumsum(is_changepoint) % 2,
        'allele2': 1 - (np.cumsum(is_changepoint) % 2),
    }


def _flips(allele):
    """1.0 where a draw's phase flips from the het SNP before, 0.0 at the
    first."""
    flips = np.abs(np.diff(allele.astype(float), prepend=np.nan))
    flips[:1] = 0.0
    return flips


SITE_KEY = ['chromosome', 'position', 'ref', 'alt']


def calculate_haplotypes(phasing_samples, changepoint_threshold=0.95):
    """Consensus haplotype blocks from sampled phasings (Tables with
    chromosome, position, ref, alt, allele1, allele2).

    Each sample contributes, per het SNP, whether its phase flips relative
    to the previous het SNP; the flip fractions are averaged over the
    samples, which must phase the same het sites in the same order, and
    cut into blocks by ``_haplotype_blocks``.
    """
    fraction_sum, sites, num_samples = None, None, 0
    for sample in phasing_samples:
        het = sample.take(sample['allele1'] != sample['allele2'])
        keys = [het[c] for c in SITE_KEY]
        if sites is None:
            sites = keys
        elif not all(len(a) == len(b) and np.array_equal(a, b)
                     for a, b in zip(sites, keys)):
            raise ValueError('phasing samples phase different het sites')
        flips = _flips(het['allele1'])
        fraction_sum = flips if fraction_sum is None else fraction_sum + flips
        num_samples += 1

    fraction = fraction_sum / float(num_samples)
    chrom = sites[0]
    chrom_different = np.concatenate(
        [[True], chrom[1:] != chrom[:-1]]) if len(chrom) else \
        np.array([], dtype=bool)
    blocks = _haplotype_blocks(fraction, chrom_different,
                               changepoint_threshold)
    consensus = Table(list(zip(SITE_KEY, sites))
                      + [('fraction_changepoint', fraction)])
    consensus['not_confident'] = (blocks['changepoint_confidence']
                                  < float(changepoint_threshold))
    consensus['chrom_different'] = chrom_different
    for name, values in blocks.items():
        consensus[name] = values
    return consensus


def _stack_allele_rows(haps):
    """One row per (SNP, allele_id): allele_id 0 carries allele1, allele_id
    1 carries allele2."""
    n = len(haps)
    return Table([
        ('chromosome', np.concatenate([haps['chromosome']] * 2)),
        ('position', np.concatenate([haps['position']] * 2)),
        ('allele', np.concatenate([haps['allele1'], haps['allele2']])),
        ('hap_label', np.concatenate([haps['hap_label']] * 2)),
        ('allele_id', np.repeat(np.arange(2), n)),
    ])


def _write_null_haps(haps_filename):
    write_tsv(_empty(HAPS_COLUMNS), haps_filename)


# ---------------------------------------------------------------------------
# GRCh38: shapeit4
# ---------------------------------------------------------------------------

def _to_1kg_chromosome(chromosome, chr_name_prefix):
    """Map a sample chromosome name onto the chr-prefixed 1kg naming."""
    if chr_name_prefix == '':
        return 'chr' + chromosome
    if chr_name_prefix == 'chr':
        return chromosome
    raise ValueError(
        'unrecognized chr_name_prefix {!r}'.format(chr_name_prefix))


def _read_snp_positions(snp_positions_filename, chromosome):
    """The SNP panel's rows (no header: chromosome, 1-based position, ref,
    alt) on one chromosome, in file order."""
    prefix = chromosome + '\t'
    position, ref, alt = [], [], []
    with open(snp_positions_filename) as f:
        for line in f:
            if line.startswith(prefix):
                fields = line.rstrip('\n').split('\t')
                position.append(int(fields[1]))
                ref.append(fields[2])
                alt.append(fields[3])
    return Table([('chromosome', np.array([chromosome] * len(position),
                                          dtype=object)),
                  ('position', np.array(position, dtype=np.int64)),
                  ('ref', np.array(ref, dtype=object)),
                  ('alt', np.array(alt, dtype=object))])


def _load_het_positions(snp_genotype_filename, snp_positions_filename,
                        chromosome):
    """Het SNPs of one chromosome joined with their ref/alt bases, in the
    genotype table's order (each with every panel row at its position)."""
    positions = _read_snp_positions(snp_positions_filename, chromosome)
    genotypes = read_tsv(snp_genotype_filename)
    rows_at = {}
    for j, pos in enumerate(positions['position'].tolist()):
        rows_at.setdefault(pos, []).append(j)
    left, right = [], []
    for i, pos in enumerate(genotypes['position'].tolist()):
        for j in rows_at.get(pos, ()):
            left.append(i)
            right.append(j)
    if not left:
        raise ValueError('no snps to phase')
    left, right = np.array(left), np.array(right)
    is_het = ((genotypes['AB'][left] == 1) & (genotypes['AA'][left] == 0)
              & (genotypes['BB'][left] == 0))
    left, right = left[is_het], right[is_het]
    return Table([('position', genotypes['position'][left]),
                  ('ref', positions['ref'][right]),
                  ('alt', positions['alt'][right])])


def _stage_het_bcf(het_snps, chromosome_1kg, temp_directory):
    """Write the het SNPs as an indexed BCF for shapeit4."""
    vcf_filename = os.path.join(temp_directory, 'het_snps.vcf')
    bcf_filename = os.path.join(temp_directory, 'het_snps.bcf')
    for stale in (vcf_filename, vcf_filename + '.gz',
                  vcf_filename + '.gz.tbi'):
        if os.path.exists(stale):
            os.remove(stale)

    with open(vcf_filename, 'w') as f:
        f.write('##fileformat=VCFv4.2\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                'Description="Genotype">\n')
        f.write('#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t'
                'NORMAL\n')
        for pos, ref, alt in zip(het_snps['position'].tolist(),
                                 het_snps['ref'], het_snps['alt']):
            f.write('{c}\t{p}\t{c}_{p}_{r}_{a}\t{r}\t{a}\t.\t.\t.\tGT\t0/1\n'
                    .format(c=chromosome_1kg, p=pos, r=ref, a=alt))

    _run('bgzip', '--force', vcf_filename)
    _run('tabix', vcf_filename + '.gz')
    _run('bcftools', 'view', '-O', 'b', vcf_filename + '.gz',
         '-o', bcf_filename)
    _run('bcftools', 'index', bcf_filename)
    return bcf_filename


def read_bcf_phased_genotypes(bcf_filename):
    """Phased alleles from a BCF via ``bcftools view -H`` text output: one
    row per (site, alternate allele) with chromosome, position, ref, alt,
    allele1 and allele2."""
    text = subprocess.run(
        ['bcftools', 'view', '-H', bcf_filename],
        capture_output=True, text=True, check=True).stdout
    chromosome, position, ref, alt, allele1, allele2 = ([] for _ in range(6))
    for line in text.splitlines():
        fields = line.split('\t', 10)
        genotype = fields[9].split(':')[0].replace('/', '|')
        a1, a2 = (int(a) for a in genotype.split('|'))
        for alt_allele in fields[4].split(','):
            chromosome.append(fields[0])
            position.append(int(fields[1]))
            ref.append(fields[3])
            alt.append(alt_allele)
            allele1.append(a1)
            allele2.append(a2)
    return Table([('chromosome', np.array(chromosome, dtype=object)),
                  ('position', np.array(position, dtype=np.int64)),
                  ('ref', np.array(ref, dtype=object)),
                  ('alt', np.array(alt, dtype=object)),
                  ('allele1', np.array(allele1, dtype=np.int64)),
                  ('allele2', np.array(allele2, dtype=np.int64))])


def infer_haps_grch38_shapeit4(haps_filename, snp_genotype_filename,
                               chromosome, temp_directory, config,
                               ref_data_dir):
    """GRCh38 phasing: a shapeit4 phasing graph, ``shapeit_num_samples``
    bingraphsample draws and their consensus blocks, written as the haps
    table."""
    chromosome_1kg = _to_1kg_chromosome(
        chromosome, _param(config, 'chr_name_prefix'))

    phased_x = _param(config, 'grch38_1kg_phased_chromosome_x')
    unphasable = (
        str(chromosome_1kg) not in _param(config, 'grch38_1kg_chromosomes')
        # male X carries no het snps
        or (chromosome == phased_x and not _param(config, 'is_female')))
    if unphasable:
        _write_null_haps(haps_filename)
        return

    os.makedirs(temp_directory, exist_ok=True)

    het_snps = _load_het_positions(
        snp_genotype_filename,
        _ref_file(config, ref_data_dir, 'snp_positions'),
        chromosome)
    het_bcf = _stage_het_bcf(het_snps, chromosome_1kg, temp_directory)

    if chromosome_1kg == phased_x:
        panel_bcf = _ref_file(config, ref_data_dir,
                              'grch38_1kg_X_bcf_filename')
    else:
        panel_bcf = _ref_file(config, ref_data_dir, 'grch38_1kg_bcf_filename',
                              chromosome=chromosome_1kg)

    bingraph_filename = os.path.join(temp_directory, 'phasing.bingraph')
    _run('shapeit4',
         '--input', het_bcf,
         '--map', _ref_file(config, ref_data_dir,
                            'genetic_map_grch38_filename',
                            chromosome=chromosome_1kg),
         '--region', chromosome_1kg,
         '--reference', panel_bcf,
         '--bingraph', bingraph_filename)

    sample_filenames = []
    for seed in range(_param(config, 'shapeit_num_samples')):
        sample_filename = os.path.join(
            temp_directory, 'sampled.{}.bcf'.format(seed))
        _run('bingraphsample', '--input', bingraph_filename,
             '--output', sample_filename, '--sample', '--seed', str(seed))
        _run('bcftools', 'index', '-f', sample_filename)
        sample_filenames.append(sample_filename)

    consensus = calculate_haplotypes(
        (read_bcf_phased_genotypes(f) for f in sample_filenames),
        changepoint_threshold=_param(config, 'shapeit_confidence_threshold'))

    haps = _stack_allele_rows(consensus)
    if _param(config, 'chr_name_prefix') == '':
        if not all(str(c).startswith('chr') for c in haps['chromosome']):
            raise ValueError('unexpected chromosome prefix')
        haps['chromosome'] = np.array([c[3:] for c in haps['chromosome']],
                                      dtype=object)

    write_tsv(haps.select(HAPS_COLUMNS), haps_filename)


# ---------------------------------------------------------------------------
# GRCh37: shapeit2
# ---------------------------------------------------------------------------

SHAPEIT2_BASES = ('A', 'C', 'T', 'G')
SHAPEIT2_SAMPLE = 'ID_1 ID_2 missing sex\n0 0 0 0\nUNR1 UNR1 0 2\n'


def _stage_shapeit2_inputs(snp_genotype_filename, legend_filename,
                           chromosome, temp_directory):
    """Write the .gen and .sample inputs of shapeit2: one .gen row for each
    legend row with single-base A/C/G/T alleles at the position of a called
    genotype (homozygous calls too), in legend order. Returns their paths,
    or (None, None) when no row is staged."""
    genotypes = read_tsv(snp_genotype_filename)
    if len(genotypes) == 0:
        return None, None
    calls = np.stack([genotypes[g].astype(np.int64)
                      for g in ('AA', 'AB', 'BB')], axis=1)
    called = (calls == 1).any(axis=1)

    position, a0, a1 = read_legend(legend_filename)
    snp = np.isin(a0, SHAPEIT2_BASES) & np.isin(a1, SHAPEIT2_BASES)
    position, a0, a1 = position[snp], a0[snp], a1[snp]

    # an inner merge on position: every legend row, in legend order, with
    # the called row at its position
    legend_row, called_row = _match_rows(
        position, genotypes['position'][called].astype(np.int64))
    if len(legend_row) == 0:
        return None, None
    calls = calls[called][called_row]

    gen_filename = os.path.join(temp_directory, 'snps.gen')
    with open(gen_filename, 'w') as f:
        f.writelines(
            '{c} {c}:{p} {p} {a} {b} {aa} {ab} {bb}\n'.format(
                c=chromosome, p=p, a=a, b=b, aa=aa, ab=ab, bb=bb)
            for p, a, b, (aa, ab, bb) in zip(
                position[legend_row].tolist(), a0[legend_row],
                a1[legend_row], calls.tolist()))

    sample_filename = os.path.join(temp_directory, 'snps.sample')
    with open(sample_filename, 'w') as f:
        f.write(SHAPEIT2_SAMPLE)
    return gen_filename, sample_filename


def _sample_shapeit2_phasing(hgraph_filename, sample_prefix, seed,
                             max_attempts=3):
    """One phasing draw from the shapeit2 haplotype graph, retried up to
    ``max_attempts`` times on a failed call (shapeit occasionally crashes
    while sampling). Returns (position, allele1) of its het rows, in the
    draw's order, and removes the draw's files."""
    log_filename = sample_prefix + '.log'
    for _ in range(max_attempts):
        try:
            _run('shapeit', '-convert', '--input-graph', hgraph_filename,
                 '--output-sample', sample_prefix,
                 '--seed', str(seed), '-L', log_filename)
            break
        except subprocess.CalledProcessError:
            print('failed sampling with seed {}, retrying'.format(seed))
    else:
        raise RuntimeError('failed to sample {} times with seed {}'.format(
            max_attempts, seed))

    # id id2 position ref alt allele1 allele2, no header
    draw = np.loadtxt(sample_prefix + '.haps', dtype=np.int64, delimiter=' ',
                      usecols=(2, 5, 6), ndmin=2)
    het = draw[:, 1] != draw[:, 2]

    for suffix in ('.log', '.haps', '.sample'):
        os.remove(sample_prefix + suffix)
    return draw[het, 0], draw[het, 1]


def _flip_sum(draws):
    """The flips of the draws ((position, allele1) each) summed by position.

    Draws that phase the same het positions in the same order, as draws
    from one graph do, add row by row. Where two draws' het positions
    differ, the sum is the JAX code's sum of position-indexed series: the
    sorted union of the positions, NaN where a draw lacks one (such a
    position then splits no block); a position repeated in either draw
    raises ``ValueError``."""
    positions, total = None, None
    for position, allele in draws:
        flips = _flips(allele)
        if total is None:
            positions, total = position, flips
        elif len(position) == len(positions) and \
                np.array_equal(position, positions):
            total = total + flips
        else:
            if len(np.unique(position)) != len(position) or \
                    len(np.unique(positions)) != len(positions):
                raise ValueError('phasing draws with repeated positions '
                                 'phase different het sites')
            union = np.union1d(positions, position)
            summed = np.full(len(union), np.nan)
            summed[np.searchsorted(union, positions)] = total
            aligned = np.full(len(union), np.nan)
            aligned[np.searchsorted(union, position)] = flips
            positions, total = union, summed + aligned
    return total


def infer_haps_grch37_shapeit2(haps_filename, snp_genotype_filename,
                               chromosome, temp_directory, config,
                               ref_data_dir):
    """GRCh37 phasing: a shapeit2 haplotype graph of the called SNPs,
    ``shapeit_num_samples`` draws from it, and blocks where the draws'
    flips agree, written as the haps table. Autosomes are phased, and X
    (through the panel chromosome ``phased_chromosome_x``) when
    ``is_female``; any other chromosome, or one with no staged SNP, gets
    null haps."""
    phasable = [str(a) for a in range(1, 23)] + ['X']
    if str(chromosome) not in phasable or (
            chromosome == 'X' and not _param(config, 'is_female')):
        _write_null_haps(haps_filename)
        return

    os.makedirs(temp_directory, exist_ok=True)

    panel_chromosome = chromosome
    if chromosome == 'X':
        panel_chromosome = _param(config, 'phased_chromosome_x')
    legend_filename = _ref_file(config, ref_data_dir, 'legend',
                                chromosome=panel_chromosome)

    gen_filename, sample_filename = _stage_shapeit2_inputs(
        snp_genotype_filename, legend_filename, chromosome, temp_directory)
    if gen_filename is None:
        _write_null_haps(haps_filename)
        return

    hgraph_filename = os.path.join(temp_directory, 'phased.hgraph')
    _run('shapeit',
         '-M', _ref_file(config, ref_data_dir, 'genetic_map',
                         chromosome=panel_chromosome),
         '-R', _ref_file(config, ref_data_dir, 'haplotypes',
                         chromosome=panel_chromosome),
         legend_filename,
         _ref_file(config, ref_data_dir, 'sample'),
         '-G', gen_filename, sample_filename,
         '--output-graph', hgraph_filename,
         '--chrX' if chromosome == 'X' else '',
         '--no-mcmc', '-L', hgraph_filename + '.log', '--seed', '12345')

    num_samples = _param(config, 'shapeit_num_samples')
    draws = [_sample_shapeit2_phasing(
        hgraph_filename,
        os.path.join(temp_directory, 'sampled.{}'.format(seed)), seed)
        for seed in range(num_samples)]
    flip_sum = _flip_sum(draws)
    position, allele = draws[-1]
    if len(flip_sum) != len(position):
        raise ValueError('the flip sum has {} positions, the last draw {}'
                         .format(len(flip_sum), len(position)))

    blocks = _haplotype_blocks(flip_sum / float(num_samples),
                               np.zeros(len(flip_sum), dtype=bool),
                               _param(config, 'shapeit_confidence_threshold'))

    # the alleles are the last draw's; the labels count the low-confidence
    # positions up to and including each, one above the 0-based labels of
    # _haplotype_blocks, as the JAX package numbers them
    haps = _stack_allele_rows(Table([
        ('chromosome', np.array([chromosome] * len(position), dtype=object)),
        ('position', position),
        ('allele1', allele),
        ('allele2', 1 - allele),
        ('hap_label', blocks['hap_label'] + 1),
    ]))
    haps = haps.take(np.lexsort((haps['allele_id'], haps['position'])))
    write_tsv(haps.select(HAPS_COLUMNS), haps_filename)


def infer_haps(haps_filename, snp_genotype_filename, chromosome,
               temp_directory, config, ref_data_dir):
    """Phase one chromosome with the genome build's tool: GRCh38 through
    shapeit4, GRCh37 through shapeit2."""
    build = _param(config, 'ensembl_genome_version')
    phasing = {
        'GRCh38': infer_haps_grch38_shapeit4,
        'GRCh37': infer_haps_grch37_shapeit2,
    }
    if build not in phasing:
        raise ValueError('unsupported genome version {}'.format(build))
    phasing[build](haps_filename, snp_genotype_filename, chromosome,
                   temp_directory, config, ref_data_dir)


# ---------------------------------------------------------------------------
# Block allele counting and cross-sample phasing
# ---------------------------------------------------------------------------

def _match_rows(left_keys, right_keys):
    """(left row, right row) of every pair with equal keys, in left order
    and, for a left row, in right order (an inner merge's order)."""
    order = np.argsort(right_keys, kind='stable')
    sorted_keys = right_keys[order]
    lo = np.searchsorted(sorted_keys, left_keys, side='left')
    hi = np.searchsorted(sorted_keys, left_keys, side='right')
    counts = hi - lo
    return (np.repeat(np.arange(len(left_keys)), counts),
            order[segalg.vrange(lo, counts)])


def count_allele_reads(seqdata_filename, haps, chromosome, segments,
                       filter_duplicates=False, map_qual_threshold=1):
    """Read count per (segment, haplotype block, allele) of one chromosome.

    Each allele row of the seqdata matches the haps rows of its position
    and allele; a fragment votes once, for the first of its matching rows
    in seqdata order, if it passes the duplicate and mapping-quality
    filters and lies wholly inside a segment.
    """
    on_chrom = haps['chromosome'] == chromosome
    hap_position = haps['position'][on_chrom].astype(np.int64)
    hap_allele = haps['allele'][on_chrom].astype(np.int64)
    hap_label = haps['hap_label'][on_chrom].astype(np.int64)
    hap_allele_id = haps['allele_id'][on_chrom].astype(np.int64)

    alleles = seqdataio.read_allele_data(seqdata_filename, chromosome)
    vote_row, hap_row = _match_rows(
        alleles['position'].astype(np.int64) * 2 + alleles['is_alt'],
        hap_position * 2 + hap_allele)
    vote_fragment = alleles['fragment_id'][vote_row]

    fragments = seqdataio.read_fragment_data(
        seqdata_filename, chromosome,
        filter_duplicates=filter_duplicates,
        map_qual_threshold=map_qual_threshold)
    vote_idx, fragment_idx = _match_rows(vote_fragment,
                                         fragments['fragment_id'])
    # one vote per fragment: its first matching row
    _, first = np.unique(vote_fragment[vote_idx], return_index=True)
    first = np.sort(first)
    vote_idx, fragment_idx = vote_idx[first], fragment_idx[first]

    order = np.argsort(segments['start'], kind='stable')
    seg_start = segments['start'][order]
    seg_end = segments['end'][order]
    segment_idx = segalg.find_contained_segments(
        np.stack([seg_start, seg_end], axis=1),
        np.stack([fragments['start'][fragment_idx],
                  fragments['end'][fragment_idx]], axis=1))
    inside = segment_idx >= 0
    if not inside.any():
        return _empty(['chromosome'] + ALLELE_COUNT_COLUMNS[:-1])

    rows = hap_row[vote_idx[inside]]
    keys = np.stack([segment_idx[inside], hap_label[rows],
                     hap_allele_id[rows]], axis=1)
    groups, readcount = np.unique(keys, axis=0, return_counts=True)
    return Table([
        ('start', seg_start[groups[:, 0]]),
        ('end', seg_end[groups[:, 0]]),
        ('hap_label', groups[:, 1]),
        ('allele_id', groups[:, 2]),
        ('readcount', readcount.astype(np.int64)),
        ('chromosome', np.array([chromosome] * len(groups), dtype=object)),
    ])


def _concat(tables):
    """Rows of every table, in the first table's column order."""
    columns = tables[0].columns
    return Table([(c, np.concatenate([t[c] for t in tables]))
                  for c in columns])


def create_allele_counts(segments, seqdata_filename, haps_filename,
                         filter_duplicates=False, map_qual_threshold=1):
    """Allele counts over all chromosomes of the segments."""
    haps = read_tsv(haps_filename, str_columns=('chromosome',))
    tables = []
    for chromosome in sorted(set(segments['chromosome'])):
        rows = segments['chromosome'] == chromosome
        tables.append(count_allele_reads(
            seqdata_filename, haps, chromosome, segments.take(rows),
            filter_duplicates=filter_duplicates,
            map_qual_threshold=map_qual_threshold))
    return _concat(tables)


def _per_library_phase_evidence(allele_data):
    """Per (segment, block): the library's major allele id; per segment:
    its normalized major-minor imbalance, summed over blocks."""
    blocks = {}
    allele_ids = sorted(set(allele_data['allele_id'].tolist()))
    column = {a: k for k, a in enumerate(allele_ids)}
    for chrom, start, end, label, allele_id, count in zip(
            *(allele_data[c].tolist() for c in
              SEGMENT_KEY + ['hap_label', 'allele_id', 'readcount'])):
        row = blocks.setdefault((chrom, start, end, label),
                                np.zeros(len(allele_ids)))
        row[column[allele_id]] += count

    major, spread = {}, {}
    for key in sorted(blocks):
        counts = blocks[key]
        major[key] = allele_ids[int(np.argmax(counts))]
        diff_total = spread.setdefault(key[:3], [0.0, 0.0])
        diff_total[0] += counts.max() - counts.min()
        diff_total[1] += counts.max() + counts.min()
    with np.errstate(invalid='ignore', divide='ignore'):
        norm = {segment: np.float64(d) / np.float64(t)
                for segment, (d, t) in spread.items()}
    return major, norm


def phase_segments(*allele_counts_tables):
    """Consistent allele a/b assignment across samples: for every segment
    the library with the largest normalized allelic imbalance is trusted
    (ties and NaN to the lowest library index), and its per-block major
    allele becomes allele a in every sample."""
    evidence = [_per_library_phase_evidence(table)
                for table in allele_counts_tables]
    chosen = {}
    for library, (_, norm) in enumerate(evidence):
        for segment, value in norm.items():
            best = chosen.get(segment)
            if best is None or (not np.isnan(value) and (
                    np.isnan(best[0]) or value > best[0])):
                chosen[segment] = (value, library)
    allele_a = {}
    for library, (major, _) in enumerate(evidence):
        for block, allele_id in major.items():
            if chosen[block[:3]][1] == library:
                allele_a[block] = allele_id

    out_columns = SEGMENT_KEY + ['hap_label', 'allele_id', 'readcount',
                                 'is_allele_a']
    phased = []
    for allele_data in allele_counts_tables:
        if len(allele_data) == 0:
            phased.append(_empty(out_columns))
            continue
        blocks = list(zip(*(allele_data[c].tolist()
                            for c in SEGMENT_KEY + ['hap_label'])))
        rows = np.array([b in allele_a for b in blocks], dtype=bool)
        labelled = allele_data.take(rows).select(out_columns[:-1])
        allele_a_id = np.array([allele_a[b] for b, keep in zip(blocks, rows)
                                if keep], dtype=np.int64)
        labelled['is_allele_a'] = (labelled['allele_id']
                                   == allele_a_id).astype(np.int64)
        phased.append(Table(list(labelled.items())))
    return phased
