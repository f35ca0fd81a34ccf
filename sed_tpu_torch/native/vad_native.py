"""ctypes bindings for the native batch event decoder (a copy of
``sed_tpu/native/vad_native.py``).

The shared library is built from ``csrc/vad_decoder.cc`` with g++ on
first use into the git-ignored ``build/sed_tpu_torch/`` at the
repository root (``native/_gxx.py``).  This is a host decoder, not a
device kernel: when no compiler is available it falls back to the numpy
decoder, and callers check ``native_available()``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from sed_tpu_torch.native._gxx import HostLibrary


def _bind(lib: ctypes.CDLL) -> None:
    lib.sed_decode_tracks.restype = ctypes.c_int
    lib.sed_decode_tracks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]


_LIB = HostLibrary('vad_decoder.cc', _bind)


def _lib_path() -> str:
    return _LIB.path()


def _get_lib() -> Optional[ctypes.CDLL]:
    return _LIB.get()


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
