"""Host-side utilities (numpy): weighted sampling, FASTA/FAI io, table
sharding and merging, file plumbing.

Counterpart of ``weighted_resample``, ``weighted_percentile``,
``reverse_complement``, ``read_sequences``, ``read_chromosome_lengths``,
``sort_chromosome_names``, ``merge_files``, ``split_table``,
``merge_tables``, ``link_file``, ``BreakpointDatabase``, ``wget``,
``wget_gunzip`` and ``AutoSentinal`` of ``remixt_tpu/utils/__init__.py``;
the table functions work on the text, without pandas.
"""

import csv
import os
import shutil
import subprocess

import numpy as np

from remixt_tpu_torch.io.table import NA_FIELDS


def weighted_resample(data, weights, num_samples=10000, seed=1234):
    """Multinomial resample of ``data`` proportional to ``weights``.

    Draws from a private ``np.random.RandomState(seed)``, so callers'
    random streams are untouched and the draw equals the JAX package's.
    """
    p = np.asarray(weights, dtype=float)
    counts = np.random.RandomState(seed).multinomial(num_samples, p / p.sum())
    return np.repeat(data, counts)


def weighted_percentile(data, weights, percentile, num_samples=10000):
    """Percentile of a weighted-resampled dataset."""
    return np.percentile(
        weighted_resample(data, weights, num_samples=num_samples),
        percentile)


_DNA_COMPLEMENT = str.maketrans('ACTGactg', 'TGACtgac')


def reverse_complement(sequence):
    """Reverse complement of a DNA string."""
    return sequence.translate(_DNA_COMPLEMENT)[::-1]


def read_sequences(fasta_filename):
    """Yield (sequence id, sequence) records from a FASTA (utils.py:37-53)."""
    def flush(header, parts):
        if header is not None:
            yield header.split()[0], ''.join(parts)

    header, parts = None, []
    with open(fasta_filename, 'rt') as fasta:
        for raw in fasta:
            stripped = raw.strip()
            if stripped.startswith('>'):
                yield from flush(header, parts)
                header, parts = stripped[1:], []
            elif stripped:
                parts.append(stripped)
    yield from flush(header, parts)


def read_chromosome_lengths(genome_fai_filename):
    """{chromosome: length} from a samtools .fai index, in its order."""
    lengths = {}
    with open(genome_fai_filename) as fai:
        for line in fai:
            fields = line.rstrip('\n').split('\t')
            if len(fields) >= 2:
                lengths[fields[0]] = int(fields[1])
    return lengths


def sort_chromosome_names(chromosomes):
    """Chromosomes in numeric order first, lexical names after
    (utils.py:117-123)."""
    numeric = sorted(
        (c for c in chromosomes if str(c).isdigit()), key=int)
    named = sorted(c for c in chromosomes if not str(c).isdigit())
    return numeric + named


def merge_files(output_filename, *input_filenames):
    """Concatenate files byte-for-byte (utils.py:82-86)."""
    with open(output_filename, 'wb') as merged:
        for name in input_filenames:
            with open(name, 'rb') as part:
                shutil.copyfileobj(part, merged)


def _read_text_table(filename):
    """(header, rows) of a TSV, every field a string, blank lines skipped."""
    with open(filename, newline='') as f:
        lines = [line for line in csv.reader(f, delimiter='\t') if line]
    return (lines[0], lines[1:]) if lines else ([], [])


def _write_text_table(filename, header, rows):
    """A TSV of string rows; pandas' missing-value markers written empty,
    as a table read with ``dtype=str`` and written back has them."""
    with open(filename, 'w', newline='') as f:
        out = csv.writer(f, delimiter='\t', lineterminator='\n')
        out.writerow(header)
        for row in rows:
            out.writerow(['' if field in NA_FIELDS else field
                          for field in row])


def split_table(output_filenames, input_filename, num_rows):
    """Shard a TSV into consecutive ``num_rows`` chunks, each with the
    header."""
    header, rows = _read_text_table(input_filename)
    num_shards = -(-len(rows) // num_rows)
    for shard in range(num_shards):
        _write_text_table(output_filenames[shard], header,
                          rows[shard * num_rows:(shard + 1) * num_rows])


def merge_tables(output_filename, *input_filenames):
    """Concatenate TSV shards into one table (a dict of filenames also
    serves): columns in the order they first appear, a column a shard
    lacks written empty there."""
    if len(input_filenames) == 1 and isinstance(input_filenames[0], dict):
        input_filenames = list(input_filenames[0].values())
    header, rows = [], []
    for filename in input_filenames:
        names, lines = _read_text_table(filename)
        header += [name for name in names if name not in header]
        rows += [dict(zip(names, line)) for line in lines]
    _write_text_table(output_filename, header,
                      [[row.get(name, '') for name in header]
                       for row in rows])


def link_file(target_filename, link_filename):
    """Create or replace a symlink to ``target_filename`` (utils.py:109-114)."""
    if os.path.lexists(link_filename):
        os.remove(link_filename)
    os.symlink(os.path.abspath(target_filename), link_filename)


class BreakpointDatabase:
    """Fuzzy (chromosome, strand, position ± extend) breakpoint matcher.

    Built from a breakpoint Table (prediction_id and chromosome, strand and
    position of sides 1 and 2): per (chromosome, strand) the breakends'
    positions, sorted stably, queried with ``searchsorted`` windows.
    ``query(row, extend)`` returns the prediction id whose two breakends
    lie within ``extend`` of the probed row's two, on opposite sides, with
    the least summed distance (the lesser id on a tie), else None.
    """

    def __init__(self, breakpoints):
        seen, grouped = set(), {}
        for side in ('1', '2'):
            for row in zip(breakpoints['prediction_id'].tolist(),
                           breakpoints['chromosome_' + side].tolist(),
                           breakpoints['strand_' + side].tolist(),
                           breakpoints['position_' + side].tolist()):
                if row + (side,) in seen:
                    continue
                seen.add(row + (side,))
                prediction_id, chrom, strand, position = row
                grouped.setdefault((chrom, strand), []).append(
                    (position, prediction_id, side))

        self._index = {}
        for key, ends in grouped.items():
            order = np.argsort([end[0] for end in ends], kind='stable')
            self._index[key] = (
                np.array([ends[i][0] for i in order]),
                [ends[i][1:] for i in order])

    def _breakends_near(self, chrom, strand, target, extend):
        """[(prediction_id, side, distance)] within the extend window."""
        if (chrom, strand) not in self._index:
            return []
        positions, labels = self._index[(chrom, strand)]
        lo, hi = np.searchsorted(
            positions, [target - extend, target + extend + 1])
        return [(pid, side, abs(int(positions[i]) - int(target)))
                for i, (pid, side) in zip(range(lo, hi), labels[lo:hi])]

    def query(self, row, extend=0):
        near = [
            self._breakends_near(row['chromosome_' + probe_side],
                                 row['strand_' + probe_side],
                                 row['position_' + probe_side], extend)
            for probe_side in ('1', '2')]

        best = None
        for pid_1, side_1, d1 in near[0]:
            for pid_2, side_2, d2 in near[1]:
                if pid_1 == pid_2 and side_1 != side_2:
                    key = (d1 + d2, pid_1)
                    if best is None or key < best:
                        best = key
        return best[1] if best is not None else None


def wget(url, filename):
    """Download ``url`` to ``filename`` with the ``wget`` tool, through a
    staging file renamed into place (utils.py:196-199)."""
    staging = filename + '.tmp'
    subprocess.check_call(['wget', url, '-c', '-O', staging])
    os.rename(staging, filename)


def wget_gunzip(url, filename):
    """Download a .gz with ``wget`` and decompress it into place with
    ``gunzip`` (utils.py:189-193)."""
    staging = filename + '.tmp'
    subprocess.check_call(['wget', url, '-c', '-O', staging + '.gz'])
    subprocess.check_call(['gunzip', staging + '.gz'])
    os.rename(staging, filename)


class AutoSentinal:
    """Runs each step once: a step whose sentinel file (the prefix and the
    step function's name) exists is skipped, and the sentinel is written
    when the step returns (utils.py:202-212)."""

    def __init__(self, sentinal_prefix):
        self.sentinal_prefix = sentinal_prefix

    def run(self, step):
        marker = self.sentinal_prefix + step.__name__
        if not os.path.exists(marker):
            step()
            open(marker, 'w').close()
