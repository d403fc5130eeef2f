"""A results store on disk, with or without h5py.

A store whose name ends in ``.h5`` is an HDF5 file in the JAX package's
layout (``io/hdf5.py``; h5py imported when it opens); any other name is a
directory of TSV tables (``io/table.write_tables``), which needs nothing
beyond numpy and serves where h5py is not installed. ``store_name`` picks
the file where h5py is installed.
"""

import importlib.util

from remixt_tpu_torch.io import hdf5
from remixt_tpu_torch.io.table import read_tables, write_tables


def is_hdf5(path):
    return str(path).endswith('.h5')


def store_name(stem):
    """``stem.h5`` where h5py is installed, else the directory ``stem``."""
    return stem + '.h5' if importlib.util.find_spec('h5py') else stem


def write_store(path, tables):
    """Write ``{key: Table or Series}`` to a new store at ``path``."""
    if is_hdf5(path):
        hdf5.write_store(path, tables)
    else:
        write_tables(path, tables)


def read_store(path, keys=None):
    """Every key of the store at ``path``, '/'-prefix dropped; with
    ``keys``, only those of them that are there."""
    if not is_hdf5(path):
        return read_tables(path, keys)
    with hdf5.HDFStore(path, 'r') as store:
        return {key.lstrip('/'): store[key] for key in store.keys()
                if keys is None or key.lstrip('/') in keys}
