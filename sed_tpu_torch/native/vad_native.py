"""ctypes bindings for the native batch event decoder (a copy of
``sed_tpu/native/vad_native.py``).

The shared library is built from ``csrc/vad_decoder.cc`` with g++ on
first use into the git-ignored ``build/sed_tpu_torch/`` at the
repository root, under a name that carries a hash of the source and the
flags (plain ctypes keeps the binding dependency-free).  This is a host
decoder, not a device kernel: when no compiler is available it falls
back to the numpy decoder, and callers check ``native_available()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, 'csrc', 'vad_decoder.cc')
_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'sed_tpu_torch')


def _lib_path() -> str:
    h = hashlib.sha256(' '.join(_FLAGS).encode())
    with open(_SRC, 'rb') as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR,
                        f'libvad_decoder-{h.hexdigest()[:16]}.so')


_lib = None
_lock = threading.Lock()
_build_failed = False


def _compile(out_path: str) -> None:
    # build into a private temp file and rename into place: os.rename is
    # atomic, so concurrent processes (test workers, multi-host ranks on
    # a shared filesystem) never dlopen a half-written ELF
    tmp = f'{out_path}.tmp.{os.getpid()}'
    try:
        subprocess.run(['g++', *_FLAGS, _SRC, '-o', tmp], check=True,
                       capture_output=True)
        os.rename(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        path = _lib_path()
        if not os.path.isfile(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            _compile(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            # foreign-arch binary on disk: rebuild once and retry
            _compile(path)
            lib = ctypes.CDLL(path)
    except (OSError, subprocess.CalledProcessError) as exc:
        logging.warning('native vad decoder unavailable: %s', exc)
        _build_failed = True
        return None
    lib.sed_decode_tracks.restype = ctypes.c_int
    lib.sed_decode_tracks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def decode_packed_tracks(high: np.ndarray, low: Optional[np.ndarray],
                         t: int, n_smooth: np.ndarray, n_salt: np.ndarray,
                         max_events: int = 256
                         ) -> List[List[Tuple[int, int]]]:
    """Decode K packed-mask tracks into per-track [bgn, fin) pairs.

    Args:
      high, low: (K, tb) uint8 packed masks (np.unpackbits bit order);
        ``low=None`` skips the low-threshold pass.
      t: frames per track.
      n_smooth, n_salt: per-track int parameters, shape (K,).
    """
    lib = _get_lib()
    assert lib is not None, 'native decoder unavailable'
    high = np.ascontiguousarray(high, np.uint8)
    k, tb = high.shape
    if low is not None:
        low = np.ascontiguousarray(low, np.uint8)
        assert low.shape == high.shape
    n_smooth = np.ascontiguousarray(n_smooth, np.int32)
    n_salt = np.ascontiguousarray(n_salt, np.int32)
    # a track of t frames can hold at most ceil(t/2) distinct events; if
    # any track fills the output buffer the C side may have truncated —
    # retry with a larger cap so native == numpy on pathological tracks
    hard_cap = t // 2 + 1
    while True:
        out_pairs = np.empty((k, max_events, 2), np.int32)
        out_counts = np.empty((k,), np.int32)
        rc = lib.sed_decode_tracks(
            high.ctypes.data, 0 if low is None else low.ctypes.data,
            k, tb, t,
            n_smooth.ctypes.data, n_salt.ctypes.data,
            out_pairs.ctypes.data, out_counts.ctypes.data, max_events)
        assert rc == 0, 'native decoder failed'
        if max_events >= hard_cap or int(out_counts.max(initial=0)) \
                < max_events:
            break
        max_events = min(max_events * 4, hard_cap)
    return [
        [(int(out_pairs[i, j, 0]), int(out_pairs[i, j, 1]))
         for j in range(out_counts[i])]
        for i in range(k)
    ]
