"""Simulated germline alleles from a 1000 Genomes impute2 panel (numpy).

Counterpart of ``remixt_tpu/simulations/haplotype.py``: two germline
haplotypes per chromosome, assembled by recombining panel individuals at a
Poisson rate along the chromosome. The panel's ``.hap.gz`` is streamed
block by block and only the chosen individuals' columns are kept, so a
whole chromosome's panel (millions of rows by thousands of haplotypes) is
never held in memory.
"""

import gzip

import numpy as np

from remixt_tpu_torch import config as config_mod
from remixt_tpu_torch.io.table import Table

# decompressed bytes of the haplotype file read at a time
_HAP_BLOCK_BYTES = 1 << 26


def read_legend(legend_filename):
    """The legend's position (int64), a0 and a1 (str) columns, in file
    order, from its space-separated header line."""
    with gzip.open(legend_filename, 'rt') as f:
        header = f.readline().split()
        cols = [header.index(name) for name in ('position', 'a0', 'a1')]
        rows = [line.split() for line in f if line.strip()]
    position = np.array([int(r[cols[0]]) for r in rows], dtype=np.int64)
    a0 = np.array([r[cols[1]] for r in rows], dtype=object)
    a1 = np.array([r[cols[2]] for r in rows], dtype=object)
    return position, a0, a1


def _hap_columns(lines, width, columns):
    """The chosen columns of a block of haplotype lines, as uint8. Lines of
    single-character fields, one space apart, are sliced as bytes; any
    other line is split."""
    if all(len(line) == 2 * width for line in lines):
        grid = np.frombuffer(b''.join(lines), dtype=np.uint8).reshape(
            len(lines), 2 * width)
        return (grid[:, 2 * columns] - ord('0')).astype(np.uint8)
    return np.array([[int(fields[c]) for c in columns]
                     for fields in (line.split() for line in lines)],
                    dtype=np.uint8)


def num_panel_haplotypes(hap_filename):
    """The number of haplotypes (columns) of a haplotype file."""
    with gzip.open(hap_filename, 'rt') as f:
        return len(f.readline().split())


def read_hap_columns(hap_filename, columns):
    """The ``columns`` of every row of a haplotype file as a uint8 array
    (rows, len(columns)), streaming the file block by block."""
    columns = np.asarray(columns, dtype=np.int64)
    width = num_panel_haplotypes(hap_filename)
    blocks = []
    with gzip.open(hap_filename, 'rb') as f:
        while True:
            lines = f.readlines(_HAP_BLOCK_BYTES)
            if not lines:
                break
            if not lines[-1].endswith(b'\n'):
                lines[-1] += b'\n'
            lines = [line for line in lines if line.strip()]
            if lines:
                blocks.append(_hap_columns(lines, width, columns))
    if not blocks:
        return np.zeros((0, len(columns)), dtype=np.uint8)
    return np.concatenate(blocks)


def create_sim_alleles(chromosome, config, ref_data_dir,
                       recomb_rate=20.0 / 1.e8, rng=None):
    """Simulated germline alleles of one chromosome.

    Draws from ``rng`` (a ``np.random.RandomState``; numpy's global state
    by default) in the JAX package's order: the recombination positions,
    then the panel individual of each region. Returns a table with columns
    position (int64), ref, alt (str), is_alt_0, is_alt_1 (uint8), nt_0,
    nt_1 (str), indels dropped, sorted by position.
    """
    rng = np.random if rng is None else rng
    hap_filename = config_mod.get_filename(
        config, ref_data_dir, 'haplotypes', chromosome=chromosome)
    legend_filename = config_mod.get_filename(
        config, ref_data_dir, 'legend', chromosome=chromosome)

    position, a0, a1 = read_legend(legend_filename)
    num_1kg_individuals = num_panel_haplotypes(hap_filename) // 2

    chromosome_length = position.max() + 1000
    num_recombinations = int(np.ceil(recomb_rate * chromosome_length))

    # random recombination positions and per-region panel individuals
    recomb_positions = np.sort(
        rng.randint(1, chromosome_length, num_recombinations))
    recomb_individuals = rng.randint(
        0, num_1kg_individuals, num_recombinations + 1)

    # region k is [recomb_positions[k - 1], recomb_positions[k]); a
    # repeated position leaves an empty region, which the next one covers
    individual = recomb_individuals[
        np.searchsorted(recomb_positions, position, side='right')]

    chosen = np.unique(individual)
    individual_idx = np.searchsorted(chosen, individual)
    individual_cols = np.sort(np.concatenate([chosen * 2, chosen * 2 + 1]))
    hap_data = read_hap_columns(hap_filename, individual_cols)
    if len(hap_data) != len(position):
        raise ValueError('{} has {} rows, its legend {}'.format(
            hap_filename, len(hap_data), len(position)))
    rows = np.arange(len(position))
    is_alt_0 = hap_data[rows, individual_idx * 2]
    is_alt_1 = hap_data[rows, individual_idx * 2 + 1]

    nt_0 = np.where(is_alt_0 == 0, a0, a1)
    nt_1 = np.where(is_alt_1 == 0, a0, a1)

    # remove indels
    snv = (np.array([len(a) for a in a0]) == 1) & (
        np.array([len(a) for a in a1]) == 1)
    order = np.flatnonzero(snv)[np.argsort(position[snv], kind='stable')]
    return Table([('position', position[order]), ('ref', a0[order]),
                  ('alt', a1[order]), ('is_alt_0', is_alt_0[order]),
                  ('is_alt_1', is_alt_1[order]), ('nt_0', nt_0[order]),
                  ('nt_1', nt_1[order])])
