"""ctypes bindings for the native IMA ADPCM encoder (a copy of
``sed_tpu/native/adpcm_native.py``).

Built from ``csrc/adpcm_codec.cc`` with g++ on first use into
``build/sed_tpu_torch/`` (``native/_gxx.py``, as the event decoder).
Callers check ``native_available()`` and fall back to the numpy encoder
(``audio_io.adpcm_encode_np``); the two are bit-exact.
"""

from __future__ import annotations

import ctypes

import numpy as np

from sed_tpu_torch.native._gxx import HostLibrary


def _bind(lib: ctypes.CDLL) -> None:
    lib.sed_adpcm_encode.restype = ctypes.c_int
    lib.sed_adpcm_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.sed_adpcm_encode_n.restype = ctypes.c_int
    lib.sed_adpcm_encode_n.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]


_LIB = HostLibrary('adpcm_codec.cc', _bind)


def _lib_path() -> str:
    return _LIB.path()


def native_available() -> bool:
    return _LIB.get() is not None


def encode(x: np.ndarray, block_align: int) -> np.ndarray:
    """int16 (B, S) -> (B, nbl*block_align + 1) uint8 ADPCM wire rows
    (bit-exact to ``audio_io.adpcm_encode_np``)."""
    lib = _LIB.get()
    assert lib is not None, 'native adpcm encoder unavailable'
    x = np.ascontiguousarray(x, np.int16)
    assert x.ndim == 2, x.shape
    b, s = x.shape
    spb = (block_align - 4) * 2 + 1
    nbl = -(-s // spb)
    out = np.empty((b, nbl * block_align + 1), np.uint8)
    rc = lib.sed_adpcm_encode(x.ctypes.data, b, s, block_align,
                              out.ctypes.data)
    assert rc == 0, 'native adpcm encode failed'
    return out


def encode_n(x: np.ndarray, bits: int, block_align: int) -> np.ndarray:
    """int16 (B, S) -> narrow-code (bits in {2, 3}) ADPCM wire rows
    (bit-exact to ``audio_io.adpcm_n_encode_np``)."""
    from sed_tpu_torch.data.audio_io import ADPCM_N_PAD
    lib = _LIB.get()
    assert lib is not None, 'native adpcm encoder unavailable'
    x = np.ascontiguousarray(x, np.int16)
    assert x.ndim == 2, x.shape
    b, s = x.shape
    spb = (block_align - 4) * 8 // bits + 1
    nbl = -(-s // spb)
    pad = ADPCM_N_PAD[bits]
    out = np.empty((b, nbl * block_align + pad), np.uint8)
    rc = lib.sed_adpcm_encode_n(x.ctypes.data, b, s, block_align, bits,
                                pad, out.ctypes.data)
    assert rc == 0, 'native adpcm_n encode failed'
    return out
