"""Builds the package's CUDA sources into shared libraries and loads
them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C functions and is compiled on
first use with ``nvcc`` for Hopper (``sm_90a``) into
``filter_functions_tpu_torch/_build/``.  The library's file name carries
a hash of the source and the flags, so an edited source is rebuilt and
a current one is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE / 'csrc'
BUILD_DIR = _PACKAGE / '_build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get('CUDA_HOME')
    if home and (Path(home) / 'bin' / 'nvcc').exists():
        return str(Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    fallback = Path('/usr/local/cuda/bin/nvcc')
    if fallback.exists():
        return str(fallback)
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH '
                       'to build the CUDA kernels')


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives."""
    source = (SOURCE_DIR / f'{name}.cu').read_bytes()
    tag = hashlib.sha1(source + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{tag[:12]}.so'


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless a current build exists.

    Returns the library's path and the compiler's report (``-Xptxas -v``:
    registers, shared memory and spills per kernel), which is kept
    beside the library.
    """
    lib = library_path(name)
    report = lib.with_suffix('.ptxas.txt')
    if lib.exists() and report.exists():
        return lib, report.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp,
           str(SOURCE_DIR / f'{name}.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed ({proc.returncode}) building '
                           f'{name}:\n{proc.stdout}{proc.stderr}')
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, report.read_text()


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))
