"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/sed_tpu_torch/`` at the
repository root, then loaded with ``ctypes``.  The library's file name
carries a hash of every source under ``csrc/`` (``.cu`` and the ``.cuh``
headers they include) and of the flags, so an edited source or header
is rebuilt and a stale library is never loaded.  The first ``load`` that
finds its library missing compiles every missing one at once, one
``nvcc`` each, so that a fresh checkout or an edited source costs one
build's wall time, not one a library.  The compiler's output
(ptxas registers and spills) is kept beside the library.  Nothing is
built when the module is imported; there is no fallback when ``nvcc``
is missing.  ``launch`` calls a library's C launch function on a
device's current stream and raises on the error it returns.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu``'s library of the present sources lives."""
    return os.path.join(BUILD_DIR,
                        f'lib{name}-{source_digest(CSRC, NVCC_FLAGS)}.so')


def _compile(name: str) -> float:
    """Compile ``csrc/<name>.cu`` with ``nvcc``; its seconds."""
    src = os.path.join(CSRC, f'{name}.cu')
    path = library_path(name)
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
        with open(tmp + '.log', 'w') as f:
            f.write(proc.stdout + proc.stderr)
        os.rename(tmp + '.log', path + '.log')
        os.rename(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


_build_lock = threading.Lock()
_build_seconds = {}   # name -> nvcc seconds of this process's build
_build_errors = {}    # name -> the error of this process's failed build


def _build_missing() -> None:
    """Compile every ``csrc/*.cu`` whose library is not built yet, one
    ``nvcc`` each, all at once: a forward that needs two libraries waits
    for the slower build, not for both in turn."""
    with _build_lock:
        names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith('.cu')
                       and not os.path.isfile(library_path(f[:-3])))
        if not names:
            return
        with ThreadPoolExecutor(len(names)) as pool:
            jobs = {n: pool.submit(_compile, n) for n in names}
        for name, job in jobs.items():
            try:
                _build_seconds[name] = job.result()
            except Exception as e:   # raised by load() of that library
                _build_errors[name] = e


@functools.lru_cache(maxsize=None)
def load(name: str) -> KernelLibrary:
    """Load ``csrc/<name>.cu``'s library, compiling every library not
    built yet first."""
    path = library_path(name)
    if not os.path.isfile(path):
        _build_errors.pop(name, None)
        _build_missing()
        if name in _build_errors:
            raise _build_errors[name]
    log = ''
    if os.path.isfile(path + '.log'):
        with open(path + '.log') as f:
            log = f.read()
    lib = ctypes.CDLL(path)
    lib.sed_cuda_error_string.restype = ctypes.c_char_p
    lib.sed_cuda_error_string.argtypes = [ctypes.c_int]
    return KernelLibrary(name, path, lib, log, _build_seconds.get(name, 0.0))


@functools.lru_cache(maxsize=None)
def entry(name: str, argtypes: tuple):
    """(library, C function ``sed_<name>``) of ``csrc/<name>.cu``:
    built, loaded and bound to ``argtypes`` once.  The function returns
    a cudaError_t as int."""
    kl = load(name)
    fn = getattr(kl.lib, f'sed_{name}')
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return kl, fn


def launch(name: str, argtypes: tuple, device, *args) -> None:
    """``sed_<name>(*args, stream)`` on ``device``'s current stream
    (``argtypes`` ends with the stream's); raises RuntimeError on the
    error it returns."""
    import torch
    kl, fn = entry(name, argtypes)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed: '
                           f'{kl.error_string(rc)} ({rc})')
