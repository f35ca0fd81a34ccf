"""Build a host C++ source of ``csrc/`` with g++ at first use.

The shared library goes into the git-ignored ``build/sed_tpu_torch/`` at
the repository root, under a name that carries a hash of the source and
the flags, and is loaded with ctypes (dependency-free bindings).  These
are host codecs, not device kernels: when no compiler is available the
library is reported missing and the caller takes its numpy version.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Callable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'sed_tpu_torch')
FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')


def _compile(src: str, out_path: str) -> None:
    # build into a private temp file and rename into place: os.rename is
    # atomic, so concurrent processes (test workers, multi-host ranks on
    # a shared filesystem) never dlopen a half-written ELF
    tmp = f'{out_path}.tmp.{os.getpid()}'
    try:
        subprocess.run(['g++', *FLAGS, src, '-o', tmp], check=True,
                       capture_output=True)
        os.rename(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class HostLibrary:
    """``csrc/<source>``, built and loaded on the first ``get()``;
    ``bind(lib)`` sets the functions' ctypes signatures."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.src = os.path.join(CSRC, source)
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._failed = False
        self._lock = threading.Lock()

    def path(self) -> str:
        stem = os.path.splitext(os.path.basename(self.src))[0]
        h = hashlib.sha256(' '.join(FLAGS).encode())
        with open(self.src, 'rb') as f:
            h.update(f.read())
        return os.path.join(BUILD_DIR, f'lib{stem}-{h.hexdigest()[:16]}.so')

    def _build(self) -> Optional[ctypes.CDLL]:
        try:
            path = self.path()
            if not os.path.isfile(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                _compile(self.src, path)
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                # foreign-arch binary on disk: rebuild once and retry
                _compile(self.src, path)
                lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError) as exc:
            logging.warning('native %s unavailable: %s',
                            os.path.basename(self.src), exc)
            self._failed = True
            return None
        self._bind(lib)
        return lib

    def get(self) -> Optional[ctypes.CDLL]:
        if self._lib is not None or self._failed:
            return self._lib
        with self._lock:
            if self._lib is None and not self._failed:
                self._lib = self._build()
        return self._lib
