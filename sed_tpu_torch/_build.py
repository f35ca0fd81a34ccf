"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/sed_tpu_torch/`` at the
repository root, then loaded with ``ctypes``.  The library's file name
carries a hash of every source under ``csrc/`` (``.cu`` and the ``.cuh``
headers they include) and of the flags, so an edited source or header
is rebuilt and a stale library is never loaded.  The compiler's output
(ptxas registers and spills) is kept beside the library.  Nothing is
built when the module is imported; there is no fallback when ``nvcc``
is missing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'sed_tpu_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if os.path.isfile(path):
        return path
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin): the CUDA kernels cannot be '
                       'built on this machine')


class KernelLibrary:
    """A loaded kernel library and how it was built."""

    def __init__(self, name: str, path: str, lib: ctypes.CDLL,
                 build_log: str, build_seconds: float):
        self.name = name
        self.path = path
        self.lib = lib
        self.build_log = build_log          # nvcc/ptxas output of the build
        self.build_seconds = build_seconds  # 0.0 when loaded from the cache

    def error_string(self, code: int) -> str:
        return self.lib.sed_cuda_error_string(code).decode()


def source_digest(csrc: str = CSRC, flags=NVCC_FLAGS) -> str:
    """Hash of the flags and of every ``.cu`` and ``.cuh`` file under
    ``csrc`` (names and contents)."""
    h = hashlib.sha256(' '.join(flags).encode())
    for root, dirs, files in os.walk(csrc):
        dirs.sort()
        for fname in sorted(files):
            if fname.endswith(('.cu', '.cuh')):
                path = os.path.join(root, fname)
                h.update(os.path.relpath(path, csrc).encode() + b'\0')
                with open(path, 'rb') as f:
                    h.update(f.read() + b'\0')
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load(name: str) -> KernelLibrary:
    """Compile ``csrc/<name>.cu`` (if not built yet) and load it."""
    src = os.path.join(CSRC, f'{name}.cu')
    path = os.path.join(BUILD_DIR,
                        f'lib{name}-{source_digest(CSRC, NVCC_FLAGS)}.so')
    log, seconds = '', 0.0
    if os.path.isfile(path + '.log'):
        with open(path + '.log') as f:
            log = f.read()
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # compile to a private file and rename: concurrent processes never
        # load a half-written library
        tmp = f'{path}.tmp.{os.getpid()}'
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed on {src}:\n{proc.stderr}')
            log = proc.stdout + proc.stderr
            with open(tmp + '.log', 'w') as f:
                f.write(log)
            os.rename(tmp + '.log', path + '.log')
            os.rename(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    lib.sed_cuda_error_string.restype = ctypes.c_char_p
    lib.sed_cuda_error_string.argtypes = [ctypes.c_int]
    return KernelLibrary(name, path, lib, log, seconds)
