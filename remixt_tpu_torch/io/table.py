"""Ordered column tables and a TSV reader, without pandas.

The port's stand-in for the parts of pandas' ``DataFrame`` and ``Series``
that the experiment, the read-depth table and the results store use. A
:class:`Table` is an ordered mapping of column name to a 1-D numpy array,
all of one length, with an index array and an index name; strings are
object arrays of ``str``, as pandas holds them. :func:`read_tsv` stands in
for ``pd.read_csv(sep='\\t', converters=...)`` and infers column types as
pandas does.
"""

import csv
import re

import numpy as np

# pandas' default missing-value markers (``pd.read_csv``'s na_values)
NA_FIELDS = frozenset([
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'])
_TRUE_FIELDS = frozenset(['True', 'TRUE', 'true'])
_FALSE_FIELDS = frozenset(['False', 'FALSE', 'false'])
_INF_FIELDS = {'inf': np.inf, '+inf': np.inf, 'infinity': np.inf,
               '+infinity': np.inf, '-inf': -np.inf, '-infinity': -np.inf}
_INT_FIELD = re.compile(r'^\s*[+-]?[0-9]+\s*$')
_FLOAT_FIELD = re.compile(
    r'^\s*([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?\s*$')
# powers of ten as the C literals 1e0..1e308
_POW10 = [float('1e{}'.format(i)) for i in range(309)]


def as_column(values):
    """A 1-D numpy column; numpy strings become object arrays of ``str``."""
    values = np.asarray(values)
    if values.ndim != 1:
        raise ValueError('a column must be 1-D, got shape {}'.format(
            values.shape))
    if values.dtype.kind in ('U', 'S'):
        values = np.array([str(v) for v in values], dtype=object)
    return values


class Series:
    """One labelled column: ``values``, ``index`` and ``name``."""

    def __init__(self, values, index=None, name=None):
        self.values = as_column(values)
        self.index = (np.arange(len(self.values)) if index is None
                      else as_column(index))
        if len(self.index) != len(self.values):
            raise ValueError('index and values differ in length')
        self.name = name

    @classmethod
    def from_dict(cls, mapping, name=None):
        """The values of ``mapping`` labelled by its keys, in its order
        (``pd.Series(dict)``)."""
        return cls(_typed_column(list(mapping.values())),
                   index=_typed_column(list(mapping)), name=name)

    def to_dict(self):
        return dict(zip(self.index.tolist(), self.values.tolist()))


class Table:
    """Ordered columns of one length, with an index.

    Args:
        columns: a dict or a sequence of (name, values) pairs, in order
        index: row labels (default ``0..n-1``)
        index_name: the index's name, or None
    """

    def __init__(self, columns=(), index=None, index_name=None):
        items = columns.items() if isinstance(columns, dict) else columns
        self.data = {}
        for name, values in items:
            self.data[name] = as_column(values)
        lengths = {len(v) for v in self.data.values()}
        if len(lengths) > 1:
            raise ValueError('columns differ in length: {}'.format(
                {k: len(v) for k, v in self.data.items()}))
        n = lengths.pop() if lengths else (0 if index is None else len(index))
        self.index = np.arange(n) if index is None else as_column(index)
        if len(self.index) != n:
            raise ValueError('index and columns differ in length')
        self.index_name = index_name

    @classmethod
    def from_records(cls, records):
        """A table from a list of dicts (``pd.DataFrame(records)``): columns
        in the order their names first appear, each typed from its values
        as pandas types it (bool, int64, float64, else object); a name
        missing from a record is NaN there."""
        names = []
        for record in records:
            names += [k for k in record if k not in names]
        return cls([(name, _typed_column([r.get(name, np.nan)
                                          for r in records]))
                    for name in names])

    @property
    def columns(self):
        return list(self.data)

    def __len__(self):
        return len(self.index)

    def __contains__(self, name):
        return name in self.data

    def __getitem__(self, name):
        return self.data[name]

    def __setitem__(self, name, values):
        """Set a column; a new one goes last, as pandas appends it."""
        values = as_column(values)
        if len(values) != len(self):
            raise ValueError('column {!r} has {} rows, the table {}'.format(
                name, len(values), len(self)))
        self.data[name] = values

    def items(self):
        return self.data.items()

    def select(self, names):
        """The named columns, in the given order (KeyError if one is
        missing)."""
        return Table([(name, self.data[name]) for name in names],
                     index=self.index, index_name=self.index_name)

    def take(self, rows):
        """The rows at ``rows`` (a boolean mask or integer positions), with
        their index labels."""
        rows = np.asarray(rows)
        return Table([(name, values[rows]) for name, values in self.items()],
                     index=self.index[rows], index_name=self.index_name)


def _typed_column(values):
    """A column of Python values: numpy's type for scalars (as
    ``as_column``), an object array when a value is a list, tuple or
    dict, which pandas keeps whole."""
    if not any(isinstance(v, (list, tuple, dict)) for v in values):
        return as_column(np.asarray(values))
    column = np.empty(len(values), dtype=object)
    for i, value in enumerate(values):
        column[i] = value
    return column


def inner_join(left, right, on):
    """Rows of ``left`` and ``right`` whose ``on`` values are equal, in
    ``left``'s row order (each left row once per matching right row, in
    ``right``'s order), as ``left.merge(right, on=on)``: ``left``'s
    columns, then ``right``'s without ``on``; the index runs 0..n-1."""
    shared = (set(left.columns) & set(right.columns)) - {on}
    if shared:
        raise ValueError('columns in both tables: {}'.format(sorted(shared)))
    right_rows = {}
    for j, key in enumerate(right[on]):
        right_rows.setdefault(key, []).append(j)
    left_idx, right_idx = [], []
    for i, key in enumerate(left[on]):
        for j in right_rows.get(key, ()):
            left_idx.append(i)
            right_idx.append(j)
    left_idx = np.asarray(left_idx, dtype=np.int64)
    right_idx = np.asarray(right_idx, dtype=np.int64)
    return Table([(name, values[left_idx]) for name, values in left.items()]
                 + [(name, values[right_idx]) for name, values in right.items()
                    if name != on])


def parse_float(field):
    """A decimal number as pandas' default C parser reads it
    (``precise_xstrtod``): the first 17 significant digits accumulated in
    a double, then one multiplication or division by a power of ten. It
    can differ from Python's correctly rounded ``float`` in the last bit,
    so a table read here holds pandas' values bit for bit."""
    inf = _INF_FIELDS.get(field.strip().lower())
    if inf is not None:
        return inf
    match = _FLOAT_FIELD.match(field)
    if match is None or not (match.group(2) or match.group(3)):
        raise ValueError('not a number: {!r}'.format(field))
    sign, whole, fraction, exp = match.groups()
    fraction = fraction or ''
    number, exponent, num_digits = 0.0, 0, 0
    for digit in whole:
        if num_digits < 17:
            number = number * 10. + (ord(digit) - 48)
            num_digits += 1
        else:
            exponent += 1
    for digit in fraction[:max(17 - num_digits, 0)]:
        number = number * 10. + (ord(digit) - 48)
        num_digits += 1
        exponent -= 1
    if sign == '-':
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        return np.copysign(np.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_column(fields):
    """Type one column's fields as ``pd.read_csv`` does: all integers →
    int64; else all numbers or missing → float64 (missing as NaN); all
    true/false words → bool; else ``str``."""
    if not fields:
        return np.array([], dtype=object)
    if all(f in _TRUE_FIELDS or f in _FALSE_FIELDS for f in fields):
        return np.array([f in _TRUE_FIELDS for f in fields], dtype=bool)
    if all(_INT_FIELD.match(f) for f in fields):
        try:
            return np.array([int(f) for f in fields], dtype=np.int64)
        except OverflowError:
            pass
    try:
        return np.array([np.nan if f in NA_FIELDS else parse_float(f)
                         for f in fields], dtype=np.float64)
    except ValueError:
        return np.array(fields, dtype=object)


def read_tsv(path, str_columns=(), names=None, whitespace=False):
    """A tab-separated file with a header line as a :class:`Table`.

    Column types follow ``pd.read_csv``'s inference (see
    ``_parse_column``); a column named in ``str_columns`` stays ``str``,
    as a ``str`` converter keeps it. Blank lines are skipped. With
    ``names`` the file has no header line and the columns take these
    names (``header=None, names=...``); with ``whitespace`` fields are
    split on runs of blanks (``sep=r'\\s+'``).
    """
    with open(path, newline='') as f:
        if whitespace:
            rows = [line.split() for line in f]
        else:
            rows = list(csv.reader(f, delimiter='\t'))
    rows = [row for row in rows if row]
    if names is not None:
        rows = [list(names)] + rows
    if not rows:
        raise ValueError('{} has no header line'.format(path))
    header, rows = rows[0], rows[1:]
    for i, row in enumerate(rows):
        if len(row) != len(header):
            raise ValueError('{}: line {} has {} fields, the header {}'.format(
                path, i + 2, len(row), len(header)))
    columns = []
    for k, name in enumerate(header):
        fields = [row[k] for row in rows]
        columns.append((name, np.array(fields, dtype=object)
                        if name in str_columns else _parse_column(fields)))
    return Table(columns)


def left_join(left, right, on, fill_value):
    """Every row of ``left`` with the rows of ``right`` whose ``on`` value
    equals its own, as ``left.merge(right, on=on, how='left')
    .fillna(fill_value)``: a left row without a match appears once, with
    ``fill_value`` in ``right``'s columns, which then turn float64 (from
    integers) or object (from booleans), as pandas' NaN makes them."""
    shared = (set(left.columns) & set(right.columns)) - {on}
    if shared:
        raise ValueError('columns in both tables: {}'.format(sorted(shared)))
    right_rows = {}
    for j, key in enumerate(right[on]):
        right_rows.setdefault(key, []).append(j)
    left_idx, right_idx = [], []
    for i, key in enumerate(left[on]):
        for j in right_rows.get(key, (-1,)):
            left_idx.append(i)
            right_idx.append(j)
    left_idx = np.asarray(left_idx, dtype=np.int64)
    right_idx = np.asarray(right_idx, dtype=np.int64)
    missing = right_idx < 0
    columns = [(name, values[left_idx]) for name, values in left.items()]
    for name, values in right.items():
        if name == on:
            continue
        if len(values) == 0:
            column = np.full(len(left_idx), fill_value, dtype=(
                object if values.dtype == object else np.float64))
        else:
            column = values[np.maximum(right_idx, 0)]
            if missing.any():
                if column.dtype.kind in 'iu':
                    column = column.astype(np.float64)
                elif column.dtype.kind == 'b':
                    column = column.astype(object)
                column[missing] = fill_value
        columns.append((name, column))
    return Table(columns)


def _tsv_field(value):
    """One value as ``DataFrame.to_csv`` writes it: floats in the shortest
    form that reads back as their own type (``repr`` of a float64), NaN
    and None empty."""
    if value is None:
        return ''
    if isinstance(value, np.floating):
        return '' if np.isnan(value) else str(value)
    if isinstance(value, float):
        return '' if np.isnan(value) else repr(value)
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    return str(value)


def write_tsv(table, path, header=True):
    """``table`` as a tab-separated file with a header line (unless
    ``header`` is false) and no index, as ``table.to_csv(path,
    sep='\\t', index=False)`` writes it."""
    with open(path, 'w', newline='') as f:
        out = csv.writer(f, delimiter='\t', lineterminator='\n')
        if header:
            out.writerow(table.columns)
        out.writerows(zip(*(_format_column(values)
                            for _, values in table.items())))


TABLES_MANIFEST = 'tables.json'


def _typed_fields(fields, dtype):
    """One column's TSV fields back in the dtype it was written from;
    floats through Python's correctly rounded ``float``, which reads
    ``repr`` back bit for bit."""
    if dtype.startswith('float'):
        return np.array([np.nan if f == '' else float(f) for f in fields],
                        dtype=dtype)
    if dtype == 'bool':
        return np.array([f == 'True' for f in fields], dtype=bool)
    if dtype == 'object':
        return np.array(fields, dtype=object)
    return np.array([int(f) for f in fields], dtype=dtype)


def _format_column(values):
    """A column's TSV fields as :func:`write_tsv` writes its values: a
    float column as pandas' ``to_csv`` writes it (``astype(str)``, the
    shortest text that reads back as the column's type, ``repr`` for
    float64; NaN empty)."""
    if values.dtype.kind == 'f':
        return np.where(np.isnan(values), '', values.astype(str)).tolist()
    if values.dtype == object:
        return [_tsv_field(v) for v in values.tolist()]
    return [str(v) for v in values.tolist()]


def write_tables(directory, tables):
    """``{key: Table or Series}`` as a directory of TSV files, one per key
    (the key its path, with ``.tsv``), and ``tables.json`` with each key's
    kind, column dtypes, index and names, from which :func:`read_tables`
    gives the same tables back. Written beside ``directory`` and renamed
    into place, replacing what was there."""
    import json
    import os
    import shutil

    staging = directory.rstrip('/') + '.partial'
    shutil.rmtree(staging, ignore_errors=True)
    manifest = {}
    for key, value in tables.items():
        key = key.strip('/')
        if isinstance(value, Series):
            entry = dict(kind='series', name=value.name, index_name=None)
            columns = [('__index__', value.index),
                       ('__values__', value.values)]
        elif isinstance(value, Table):
            entry = dict(kind='table', name=None, index_name=value.index_name,
                         columns=value.columns)
            columns = [('__index__', value.index)] + list(value.items())
        else:
            raise TypeError('can only store a Table or a Series, got {}'
                            .format(type(value)))
        entry['dtypes'] = [values.dtype.name for _, values in columns]
        manifest[key] = entry
        path = os.path.join(staging, key + '.tsv')
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'w', newline='') as f:
            out = csv.writer(f, delimiter='\t', lineterminator='\n')
            out.writerow([str(k) for k in range(len(columns))])
            out.writerows(zip(*(_format_column(values)
                                for _, values in columns)))
    with open(os.path.join(staging, TABLES_MANIFEST), 'w') as f:
        json.dump(manifest, f, indent=1)
    shutil.rmtree(directory, ignore_errors=True)
    os.replace(staging, directory)


def read_tables(directory, keys=None):
    """The tables :func:`write_tables` wrote, ``{key: Table or Series}``
    in the order they were written; with ``keys``, only those of them
    that are there."""
    import json
    import os

    with open(os.path.join(directory, TABLES_MANIFEST)) as f:
        manifest = json.load(f)
    tables = {}
    for key, entry in manifest.items():
        if keys is not None and key not in keys:
            continue
        with open(os.path.join(directory, key + '.tsv'), newline='') as f:
            rows = list(csv.reader(f, delimiter='\t'))[1:]
        columns = [_typed_fields([row[k] for row in rows], dtype)
                   for k, dtype in enumerate(entry['dtypes'])]
        if entry['kind'] == 'series':
            tables[key] = Series(columns[1], index=columns[0],
                                 name=entry['name'])
        else:
            tables[key] = Table(list(zip(entry['columns'], columns[1:])),
                                index=columns[0],
                                index_name=entry['index_name'])
    return tables
