"""Build and load the CUDA kernels of the package.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, from the sources in the package only, into
``build/remixt_tpu_torch/`` at the repository root, and is keyed by a hash
of the source and the flags, so a changed source is rebuilt and an
unchanged one is loaded as it is. A missing ``nvcc`` or a failed build
raises. ``defines`` build a variant of a source with preprocessor macros
defined (``-D``), such as ``FB_CHAINS_TRACE``, beside the plain one.

Host C++ sources (``csrc/<name>.cpp``, such as the BAM allele reader) are
built the same way with ``g++`` and zlib by ``build_host``/``load_host``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'remixt_tpu_torch'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_lock = threading.Lock()
_libs = {}
#: compiler output (ptxas register and shared-memory report) per library,
#: keyed by (name, *defines)
build_logs = {}


def find_nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = ([os.path.join(cuda_home, 'bin', 'nvcc')] if cuda_home
                  else []) + ['/usr/local/cuda/bin/nvcc']
    for path in candidates:
        if os.path.isfile(path):
            return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                           'to build the CUDA kernels')
    return found


def _flags(defines):
    return NVCC_FLAGS + ['-D' + d for d in defines]


def library_path(name, defines=()):
    source = (CSRC / (name + '.cu')).read_bytes()
    key = hashlib.sha256(source + ' '.join(_flags(defines)).encode())
    return BUILD_DIR / 'lib{}{}_{}.so'.format(
        name, ''.join('_' + d.lower() for d in defines), key.hexdigest()[:16])


def _compile(out, command, log_key):
    """Run ``command(tmp)`` to write a library to a temporary file beside
    ``out`` and move it into place unless ``out`` exists; a failed build
    raises with the compiler's output. Returns ``out``."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        log = build_logs[log_key] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError('{} failed for {}:\n{}'.format(
                os.path.basename(command(tmp)[0]), log_key[0], log))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(name, defines=()):
    """Compile ``csrc/<name>.cu`` (with macros ``defines``) unless its keyed
    library exists; return the library path."""
    return _compile(
        library_path(name, defines),
        lambda tmp: [find_nvcc()] + _flags(defines)
        + ['-o', tmp, str(CSRC / (name + '.cu'))],
        (name,) + tuple(defines))


def load(name, defines=()):
    """The loaded ``ctypes`` library of kernel ``name`` (with macros
    ``defines``), built on first use."""
    key = (name,) + tuple(defines)
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(str(build(name, defines)))
        return _libs[key]


HOST_FLAGS = ['-O2', '-std=c++17', '-shared', '-fPIC']
HOST_LIBS = ['-lz']


def host_library_path(name):
    source = (CSRC / (name + '.cpp')).read_bytes()
    key = hashlib.sha256(source + ' '.join(HOST_FLAGS + HOST_LIBS).encode())
    return BUILD_DIR / 'lib{}_{}.so'.format(name, key.hexdigest()[:16])


def build_host(name):
    """Compile the host source ``csrc/<name>.cpp`` with g++ unless its keyed
    library exists; return the library path. A failed build raises."""
    return _compile(
        host_library_path(name),
        lambda tmp: ['g++'] + HOST_FLAGS
        + [str(CSRC / (name + '.cpp')), '-o', tmp] + HOST_LIBS,
        (name, '.cpp'))


def load_host(name):
    """The loaded ``ctypes`` library of host source ``name``, built on first
    use."""
    key = (name, '.cpp')
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(str(build_host(name)))
        return _libs[key]
