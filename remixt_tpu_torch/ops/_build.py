"""Build and load the CUDA kernels of the package.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, from the sources in the package only, into
``build/remixt_tpu_torch/`` at the repository root, and is keyed by a hash
of the source and the flags, so a changed source is rebuilt and an
unchanged one is loaded as it is. A missing ``nvcc`` or a failed build
raises.
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
#: compiler output (ptxas register and shared-memory report) per kernel
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


def library_path(name):
    source = (CSRC / (name + '.cu')).read_bytes()
    key = hashlib.sha256(source + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / 'lib{}_{}.so'.format(name, key[:16])


def build(name):
    """Compile ``csrc/<name>.cu`` unless its keyed library exists; return
    the library path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc()] + NVCC_FLAGS + ['-o', tmp, str(CSRC / (name + '.cu'))],
            capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed for {}:\n{}'.format(
                name, build_logs[name]))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name):
    """The loaded ``ctypes`` library of kernel ``name``, built on first
    use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]
