"""The results store: tables and series in HDF5 on h5py, without pandas.

Writes and reads exactly the layout of ``remixt_tpu/io/hdf5.py``, so each
package reads the other's files. Per key, one group with a ``__kind__``
attribute (``frame`` or ``series``):

- a frame has one ``col_<name>`` dataset per column and the column order in
  ``__columns__``; a series has ``__values__`` and ``__name__``;
- both have ``__index__`` and ``__index_name__`` ('' for none);
- strings are utf-8 variable-length strings with ``__dtype__ = 'str'``,
  booleans ``uint8`` with ``__dtype__ = 'bool'``.

h5py is imported when a store is opened, so that every module of the port
imports on a machine without it.
"""

import numpy as np

from remixt_tpu_torch.io.table import Series, Table


def _h5py():
    try:
        import h5py
    except ImportError as error:
        raise ImportError(
            'the results store is an HDF5 file and needs h5py, which is not '
            'installed') from error
    return h5py


def _write_array(h5py, group, name, values):
    values = np.asarray(values)
    if values.dtype == object or values.dtype.kind in ('U', 'S'):
        data = np.asarray(['' if v is None else str(v) for v in values],
                          dtype=object)
        ds = group.create_dataset(
            name, data=data.astype(h5py.string_dtype(encoding='utf-8')))
        ds.attrs['__dtype__'] = 'str'
    elif values.dtype.kind == 'b':
        ds = group.create_dataset(name, data=values.astype(np.uint8))
        ds.attrs['__dtype__'] = 'bool'
    else:
        group.create_dataset(name, data=values)


def _read_array(group, name):
    ds = group[name]
    values = ds[()]
    kind = ds.attrs.get('__dtype__', None)
    if kind == 'str':
        return np.asarray([v.decode('utf-8') if isinstance(v, bytes) else v
                           for v in values], dtype=object)
    if kind == 'bool':
        return values.astype(bool)
    return values


class HDFStore:
    """``store[key] = table_or_series`` and ``store[key]`` over h5py.

    Args:
        path: the HDF5 file
        mode: h5py's file mode ('r', 'w', 'a')
    """

    def __init__(self, path, mode='r'):
        self._h5py = _h5py()
        self._file = self._h5py.File(path, mode)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()

    def close(self):
        self._file.close()

    @staticmethod
    def _norm(key):
        return '/' + key.strip('/')

    def keys(self):
        """Every stored key, '/'-prefixed, in h5py's visiting order."""
        found = []

        def visit(name, obj):
            if isinstance(obj, self._h5py.Group) and '__kind__' in obj.attrs:
                found.append('/' + name)
        self._file.visititems(visit)
        return found

    def __setitem__(self, key, value):
        key = self._norm(key)
        if key in self._file:
            del self._file[key]
        group = self._file.create_group(key)
        if isinstance(value, Series):
            group.attrs['__kind__'] = 'series'
            group.attrs['__name__'] = ('' if value.name is None
                                       else str(value.name))
            _write_array(self._h5py, group, '__values__', value.values)
            group.attrs['__index_name__'] = ''
        elif isinstance(value, Table):
            group.attrs['__kind__'] = 'frame'
            group.attrs['__columns__'] = [str(c) for c in value.columns]
            for name, values in value.items():
                _write_array(self._h5py, group, 'col_' + str(name), values)
            group.attrs['__index_name__'] = ('' if value.index_name is None
                                             else str(value.index_name))
        else:
            raise TypeError('can only store a Table or a Series, got {}'
                            .format(type(value)))
        _write_array(self._h5py, group, '__index__', value.index)

    def __getitem__(self, key):
        key = self._norm(key)
        if key not in self._file:
            raise KeyError(key)
        group = self._file[key]
        index = _read_array(group, '__index__')
        index_name = group.attrs.get('__index_name__', '') or None
        if group.attrs['__kind__'] == 'series':
            return Series(_read_array(group, '__values__'), index=index,
                          name=group.attrs.get('__name__', '') or None)
        columns = list(group.attrs['__columns__'])
        return Table([(c, _read_array(group, 'col_' + c)) for c in columns],
                     index=index, index_name=index_name)


def write_store(path, tables):
    """Write ``{key: Table or Series}`` to a new store at ``path``."""
    with HDFStore(path, 'w') as store:
        for key, value in tables.items():
            store[key] = value


def read_store(path):
    """Every key of the store at ``path``, '/'-prefix dropped."""
    with HDFStore(path, 'r') as store:
        return {key.lstrip('/'): store[key] for key in store.keys()}
