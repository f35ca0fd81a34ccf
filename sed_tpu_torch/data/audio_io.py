"""Audio file I/O and the constants of the uint8 wires (a copy of the
parts of ``sed_tpu/data/audio_io.py`` that the port runs).

Wav decode is scipy-based, resampling polyphase (scipy), and ffmpeg an
optional fallback for compressed formats, as in ``sed_tpu``.  The wire
section holds what the device decode (``ops/wire.py``) needs to
recognise and unpack a buffer (the G.711 mu-law table, the qN block
layout, the IMA ADPCM tables and block geometry), and the numpy
encoders and reference decoders of every wire: ``chip_smoke.py`` makes
its wire buffers with them and holds the device decode against them on
the card.  (``sed_tpu``'s ``adpcm_encode`` / ``adpcm_n_encode`` call a
native encoder that is bit-exact to the numpy ``*_encode_np`` copied
here.)
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def _to_float32(data: np.ndarray) -> np.ndarray:
    """Normalize PCM to [-1, 1] float32 (librosa convention)."""
    if data.dtype == np.float32 or data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0)
    raise ValueError(f'unsupported wav dtype: {data.dtype}')


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (Kaiser-windowed), mono float32."""
    if orig_sr == target_sr:
        return x.astype(np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    out = resample_poly(x.astype(np.float64), target_sr // g, orig_sr // g)
    return out.astype(np.float32)


def _ffmpeg_to_wav(path: str) -> str:
    """Convert a compressed file to wav via ffmpeg if available."""
    if shutil.which('ffmpeg') is None:
        raise RuntimeError(
            f'cannot decode {path!r}: not a wav file and ffmpeg is not '
            'installed')
    out = tempfile.NamedTemporaryFile(suffix='.wav', delete=False).name
    subprocess.run(['ffmpeg', '-y', '-i', path, out], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return out


def load_audio(path: str, sr: Optional[int] = None,
               mono: bool = True) -> Tuple[np.ndarray, int]:
    """Load an audio file as float32 in [-1, 1].

    Returns (waveform, sample_rate).  If ``sr`` is given the waveform is
    resampled (librosa.load semantics).
    """
    tmp = None
    if not path.lower().endswith('.wav'):
        tmp = _ffmpeg_to_wav(path)
        path = tmp
    try:
        file_sr, data = wavfile.read(path)
    finally:
        if tmp is not None:
            os.unlink(tmp)
    x = _to_float32(np.asarray(data))
    if mono and x.ndim == 2:
        x = x.mean(axis=1)
    if sr is not None and sr != file_sr:
        x = resample(x, file_sr, sr)
        file_sr = sr
    return x.astype(np.float32), int(file_sr)


def save_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write float32 [-1, 1] audio as 16-bit PCM wav."""
    data = np.clip(x, -1.0, 1.0)
    wavfile.write(path, sr, (data * 32767.0).astype(np.int16))


def pad_truncate(x: np.ndarray, max_len: int) -> np.ndarray:
    """Zero-pad or truncate to ``max_len``
    (``utils/utilities.py:66-71``)."""
    if len(x) < max_len:
        return np.concatenate(
            (x, np.zeros(max_len - len(x), dtype=x.dtype)))
    return x[:max_len]


def stack_rows(arrays) -> np.ndarray:
    """``np.stack`` for 1-D rows via row-wise fill of a preallocated
    buffer.  NumPy's multi-array concatenate path degrades past ~tens
    of MB (``sed_tpu``'s BENCHMARKS.md host-memory note) — use this for
    any corpus-sized stack on a hot path."""
    arrays = list(arrays)
    first = np.asarray(arrays[0])
    out = np.empty((len(arrays),) + first.shape, first.dtype)
    out[0] = first
    for i, a in enumerate(arrays[1:], 1):
        a = np.asarray(a)
        if a.shape != first.shape or a.dtype != first.dtype:
            # match np.stack's loudness — assignment alone would
            # silently cast mismatched dtypes or broadcast length-1 rows
            raise ValueError(
                f'stack_rows: row {i} has shape {a.shape} dtype '
                f'{a.dtype}, expected {first.shape} {first.dtype}')
        out[i] = a
    return out


# ---------------------------------------------------------------------------
# G.711 mu-law wire (1 byte/sample): decoded on the device by a 256-entry
# table gather.
# ---------------------------------------------------------------------------

_MULAW_BIAS = 0x84
_MULAW_CLIP = 32635
_mulaw_tables: dict = {}


def mulaw_decode_table() -> np.ndarray:
    """(256,) float32: G.711 mu-law code -> linear sample in [-1, 1)."""
    if 'dec' not in _mulaw_tables:
        u = np.arange(256, dtype=np.int32) ^ 0xFF
        sign = u & 0x80
        exponent = (u >> 4) & 0x07
        mantissa = u & 0x0F
        mag = (((mantissa << 3) + _MULAW_BIAS) << exponent) - _MULAW_BIAS
        lin = np.where(sign != 0, -mag, mag)
        _mulaw_tables['dec'] = (lin / 32768.0).astype(np.float32)
    return _mulaw_tables['dec']


def mulaw_encode_table() -> np.ndarray:
    """(65536,) uint8: int16 sample (viewed as uint16) -> mu-law code."""
    if 'enc' not in _mulaw_tables:
        x = np.arange(-32768, 32768, dtype=np.int32)
        sign = np.where(x < 0, 0x80, 0).astype(np.int32)
        mag = np.clip(np.abs(x), 0, _MULAW_CLIP) + _MULAW_BIAS
        exponent = (np.floor(np.log2(mag)).astype(np.int32) - 7).clip(0, 7)
        mantissa = (mag >> (exponent + 3)) & 0x0F
        code = (~(sign | (exponent << 4) | mantissa)) & 0xFF
        # index by the uint16 view of the int16 sample
        table = np.empty(65536, np.uint8)
        table[np.arange(-32768, 32768) & 0xFFFF] = code.astype(np.uint8)
        _mulaw_tables['enc'] = table
    return _mulaw_tables['enc']


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float [-1, 1] or int16 -> (same shape) uint8 mu-law codes."""
    if x.dtype != np.int16:
        x = (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    return mulaw_encode_table()[x.view(np.uint16)]


def mulaw_decode(u: np.ndarray) -> np.ndarray:
    """uint8 mu-law codes -> float32 in [-1, 1) (host-side path)."""
    return mulaw_decode_table()[u]

# ---------------------------------------------------------------------------
# qN wires (N in QN_BITS): signed N-bit codes per 128-sample block packed
# big-endian, then one float16 scale per block, in one uint8 row.
# ---------------------------------------------------------------------------

Q4_BLOCK = 128
QN_BITS = (2, 3, 4, 5, 6)


def qn_bytes(samples: int, bits: int) -> int:
    """Wire bytes for ``samples`` N-bit samples (+f16 block scales)."""
    assert samples % Q4_BLOCK == 0 and (samples * bits) % 8 == 0
    return samples * bits // 8 + (samples // Q4_BLOCK) * 2


def qn_encode(x: np.ndarray, bits: int) -> np.ndarray:
    """float [-1,1] or int16 (B, S) -> (B, qn_bytes(S, bits)) uint8."""
    assert bits in QN_BITS, bits
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32767.0
    x = np.asarray(x, np.float32)
    b, s = x.shape
    top = (1 << (bits - 1)) - 1
    blocks = x.reshape(b, s // Q4_BLOCK, Q4_BLOCK)
    scale = np.abs(blocks).max(axis=2) / top
    # floor must survive the float16 cast (1e-6 is a representable f16
    # subnormal; anything below ~6e-8 flushes to zero and poisons the
    # divide)
    scale = np.maximum(scale, 1e-6).astype(np.float16)
    q = np.clip(np.round(blocks / scale.astype(np.float32)[:, :, None]),
                -top - 1, top).astype(np.int32) + top + 1
    q = q.reshape(b, s)
    # big-endian bitstream: sample i occupies bits [i*bits, (i+1)*bits)
    shifts = np.arange(bits - 1, -1, -1)
    bit_mat = ((q[:, :, None] >> shifts[None, None, :]) & 1).astype(
        np.uint8).reshape(b, s * bits)
    codes = np.packbits(bit_mat, axis=1)
    return np.concatenate([codes, scale.view(np.uint8).reshape(b, -1)],
                          axis=1)


def qn_decode_np(buf: np.ndarray, samples: int, bits: int) -> np.ndarray:
    """Host-side reference decode (the engine decodes on device)."""
    assert bits in QN_BITS, bits
    b = buf.shape[0]
    nb = samples * bits // 8
    top = (1 << (bits - 1)) - 1
    codes = buf[:, :nb].astype(np.int32)
    scale = buf[:, nb:].view(np.float16).astype(np.float32)
    bitpos = np.arange(samples) * bits
    j = bitpos >> 3
    sh = 16 - bits - (bitpos & 7)
    lo = codes[:, np.minimum(j + 1, nb - 1)]
    q = (((codes[:, j] << 8) | lo) >> sh) & ((1 << bits) - 1)
    x = (q - top - 1).astype(np.float32).reshape(b, samples // Q4_BLOCK,
                                                 Q4_BLOCK)
    return (x * scale[:, :, None]).reshape(b, samples)

# ---------------------------------------------------------------------------
# IMA ADPCM wires.  adpcm4: the standard IMA block (4-byte header: int16
# LE predictor = sample 0, uint8 step index, reserved 0; then low-nibble-
# first 4-bit codes), 505 samples per 256-byte block.  adpcm3 / adpcm2:
# the same header and recurrences at 3- and 2-bit codes packed big-endian
# (673 / 1009 samples per block).  Rows end with ADPCM_N_PAD[bits] zero
# bytes, so ADPCM widths are odd while every qN and mu-law width is even:
# the width-keyed dispatch of ``ops/wire.dequant_wire`` cannot confuse
# them.
# ---------------------------------------------------------------------------

ADPCM_BLOCK_ALIGN = 256    # bytes/block -> 505 samples/block, 1.6% header

IMA_STEP_TABLE = np.asarray([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17,
    19, 21, 23, 25, 28, 31, 34, 37, 41, 45,
    50, 55, 60, 66, 73, 80, 88, 97, 107, 118,
    130, 143, 157, 173, 190, 209, 230, 253, 279, 307,
    337, 371, 408, 449, 494, 544, 598, 658, 724, 796,
    876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358,
    5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767],
    np.int32)

IMA_INDEX_TABLE = np.asarray(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], np.int32)


def adpcm_samples_per_block(block_align: int = ADPCM_BLOCK_ALIGN) -> int:
    assert block_align >= 8 and block_align % 4 == 0, block_align
    return (block_align - 4) * 2 + 1


def adpcm_bytes(samples: int,
                block_align: int = ADPCM_BLOCK_ALIGN) -> int:
    """WIRE bytes for `samples` samples: final partial block padded,
    plus ONE trailing pad byte.  The pad byte makes the wire width odd
    — every qN and mu-law width is even for any valid sample count, so
    the decode dispatch (``ops/wire.dequant_wire``, width-keyed) can
    never confuse an ADPCM buffer with another wire (without the pad,
    e.g. 16384 samples -> ADPCM 8448 == q4 8448).  Wav files on disk
    carry the raw blocks without the pad (``sed_tpu``'s
    ``save_wav_adpcm``)."""
    spb = adpcm_samples_per_block(block_align)
    return -(-samples // spb) * block_align + 1


def _adpcm_lanes(x: np.ndarray, block_align: int):
    """float [-1,1] / int16 (B, S) -> int32 (B*nblocks, spb) lanes,
    final block edge-padded (constant tails encode to near-zero
    nibbles)."""
    if x.dtype != np.int16:
        x = np.clip(np.round(np.asarray(x, np.float32) * 32767.0),
                    -32768, 32767).astype(np.int16)
    b, s = x.shape
    spb = adpcm_samples_per_block(block_align)
    nbl = -(-s // spb)
    pad = nbl * spb - s
    if pad:
        x = np.concatenate([x, np.repeat(x[:, -1:], pad, axis=1)], axis=1)
    return x.astype(np.int32).reshape(b * nbl, spb), b, nbl, spb


def adpcm_encode_np(x: np.ndarray,
                    block_align: int = ADPCM_BLOCK_ALIGN) -> np.ndarray:
    """Pure-numpy encode (the native encoder's bit-exactness oracle).

    Vectorized over every (clip, block) lane; the per-block initial
    step index is seeded from the block's mean |diff| (blocks are
    header-independent, so the cross-block index carry of scalar
    encoders is traded for instant per-block adaptation — the index
    reaches any level within ~7 nibbles regardless)."""
    lanes, b, nbl, spb = _adpcm_lanes(x, block_align)
    steps = IMA_STEP_TABLE
    pred = lanes[:, 0].copy()
    mean_diff = np.abs(np.diff(lanes, axis=1)).mean(axis=1)
    index = np.clip(np.searchsorted(steps, mean_diff), 0, 88).astype(
        np.int32)
    header = np.empty((lanes.shape[0], 4), np.uint8)
    header[:, 0] = pred & 0xFF
    header[:, 1] = (pred >> 8) & 0xFF
    header[:, 2] = index
    header[:, 3] = 0
    nibbles = np.empty((lanes.shape[0], spb - 1), np.uint8)
    for t in range(1, spb):
        step = steps[index]
        diff = lanes[:, t] - pred
        sign = (diff < 0).astype(np.int32) * 8
        diff = np.abs(diff)
        delta = np.zeros_like(pred)
        vpdiff = step >> 3
        for bit in (4, 2, 1):
            ge = diff >= step
            delta |= np.where(ge, bit, 0)
            diff = np.where(ge, diff - step, diff)
            vpdiff = np.where(ge, vpdiff + step, vpdiff)
            step = step >> 1
        pred = np.clip(np.where(sign, pred - vpdiff, pred + vpdiff),
                       -32768, 32767)
        nib = (sign | delta).astype(np.uint8)
        nibbles[:, t - 1] = nib
        index = np.clip(index + IMA_INDEX_TABLE[nib], 0, 88)
    packed = nibbles[:, 0::2] | (nibbles[:, 1::2] << 4)  # low nibble 1st
    blocks = np.concatenate([header, packed], axis=1).reshape(b, -1)
    return np.concatenate(                # odd-width pad byte, see
        [blocks, np.zeros((b, 1), np.uint8)], axis=1)  # adpcm_bytes


def _adpcm_split(buf: np.ndarray, block_align: int):
    """(B, adpcm_bytes(S)) uint8 -> (pred0 int32, index0 int32, nibbles
    int32 (lanes, spb-1)) per-lane decode inputs (trailing pad byte
    dropped)."""
    b = buf.shape[0]
    nbl = buf.shape[1] // block_align
    blocks = buf[:, :nbl * block_align].reshape(
        b, nbl, block_align).reshape(-1, block_align)
    pred = (blocks[:, 0].astype(np.int32)
            | (blocks[:, 1].astype(np.int32) << 8))
    pred = np.where(pred >= 32768, pred - 65536, pred)
    index = np.clip(blocks[:, 2].astype(np.int32), 0, 88)
    data = blocks[:, 4:].astype(np.int32)
    nib = np.empty((blocks.shape[0], data.shape[1] * 2), np.int32)
    nib[:, 0::2] = data & 0xF
    nib[:, 1::2] = data >> 4
    return pred, index, nib, b, nbl


def adpcm_decode_np(buf: np.ndarray, samples: int,
                    block_align: int = ADPCM_BLOCK_ALIGN) -> np.ndarray:
    """Host-side reference decode (the engine decodes on device) ->
    float32 (B, samples) in [-1, 1)."""
    pred, index, nib, b, nbl = _adpcm_split(buf, block_align)
    spb = adpcm_samples_per_block(block_align)
    out = np.empty((pred.shape[0], spb), np.int32)
    out[:, 0] = pred
    steps = IMA_STEP_TABLE
    for t in range(spb - 1):
        n = nib[:, t]
        step = steps[index]
        diff = step >> 3
        diff += np.where(n & 4, step, 0)
        diff += np.where(n & 2, step >> 1, 0)
        diff += np.where(n & 1, step >> 2, 0)
        pred = np.clip(np.where(n & 8, pred - diff, pred + diff),
                       -32768, 32767)
        out[:, t + 1] = pred
        index = np.clip(index + IMA_INDEX_TABLE[n], 0, 88)
    out = out.reshape(b, nbl * spb)[:, :samples]
    return (out / 32768.0).astype(np.float32)


ADPCM_N_PAD = {4: 1, 3: 3, 2: 5}

# IMA/DVI index-adjust tables for 3- and 2-bit codes (magnitude part
# mirrored over the sign bit, like the 16-entry 4-bit table)
IMA_INDEX_TABLE_3 = np.asarray([-1, -1, 1, 2, -1, -1, 1, 2], np.int32)
IMA_INDEX_TABLE_2 = np.asarray([-1, 2, -1, 2], np.int32)


def adpcm_index_table(bits: int) -> np.ndarray:
    return {4: IMA_INDEX_TABLE, 3: IMA_INDEX_TABLE_3,
            2: IMA_INDEX_TABLE_2}[bits]


def adpcm_n_samples_per_block(bits: int,
                              block_align: int = ADPCM_BLOCK_ALIGN) -> int:
    assert block_align >= 8 and block_align % 4 == 0, block_align
    assert bits in (2, 3, 4) and ((block_align - 4) * 8) % bits == 0
    return (block_align - 4) * 8 // bits + 1


def adpcm_n_bytes(samples: int, bits: int,
                  block_align: int = ADPCM_BLOCK_ALIGN) -> int:
    """Wire bytes for ``samples`` at code width ``bits`` (pad included;
    see the section comment for the width-disambiguation invariant)."""
    spb = adpcm_n_samples_per_block(bits, block_align)
    return -(-samples // spb) * block_align + ADPCM_N_PAD[bits]


def _adpcm_lanes_spb(x: np.ndarray, spb: int):
    """float [-1,1] / int16 (B, S) -> int32 (B*nblocks, spb) lanes,
    final block edge-padded (shared by every code width)."""
    if x.dtype != np.int16:
        x = np.clip(np.round(np.asarray(x, np.float32) * 32767.0),
                    -32768, 32767).astype(np.int16)
    b, s = x.shape
    nbl = -(-s // spb)
    pad = nbl * spb - s
    if pad:
        x = np.concatenate([x, np.repeat(x[:, -1:], pad, axis=1)], axis=1)
    return x.astype(np.int32).reshape(b * nbl, spb), b, nbl


def adpcm_n_encode_np(x: np.ndarray, bits: int,
                      block_align: int = ADPCM_BLOCK_ALIGN) -> np.ndarray:
    """float [-1,1] or int16 (B, S) -> (B, adpcm_n_bytes(S, bits))
    uint8.  Same vectorization + per-block step-index seeding as
    ``adpcm_encode_np``; the quantizer loop generalizes the IMA
    truncating shift-add to ``bits-1`` magnitude bits."""
    assert bits in (2, 3), bits
    spb = adpcm_n_samples_per_block(bits, block_align)
    lanes, b, nbl = _adpcm_lanes_spb(x, spb)
    steps = IMA_STEP_TABLE
    itab = adpcm_index_table(bits)
    sign_bit = 1 << (bits - 1)
    pred = lanes[:, 0].copy()
    mean_diff = np.abs(np.diff(lanes, axis=1)).mean(axis=1)
    index = np.clip(np.searchsorted(steps, mean_diff), 0, 88).astype(
        np.int32)
    header = np.empty((lanes.shape[0], 4), np.uint8)
    header[:, 0] = pred & 0xFF
    header[:, 1] = (pred >> 8) & 0xFF
    header[:, 2] = index
    header[:, 3] = 0
    codes = np.empty((lanes.shape[0], spb - 1), np.uint8)
    for t in range(1, spb):
        step = steps[index]
        diff = lanes[:, t] - pred
        sign = (diff < 0).astype(np.int32) * sign_bit
        diff = np.abs(diff)
        delta = np.zeros_like(pred)
        vpdiff = step >> (bits - 1)
        for bit in range(bits - 2, -1, -1):
            ge = diff >= step
            delta |= np.where(ge, 1 << bit, 0)
            diff = np.where(ge, diff - step, diff)
            vpdiff = np.where(ge, vpdiff + step, vpdiff)
            step = step >> 1
        pred = np.clip(np.where(sign, pred - vpdiff, pred + vpdiff),
                       -32768, 32767)
        code = (sign | delta).astype(np.uint8)
        codes[:, t - 1] = code
        index = np.clip(index + itab[code], 0, 88)
    # big-endian bitstream pack, qN-style: code i occupies bits
    # [i*bits, (i+1)*bits) of the (ba-4)-byte data area
    shifts = np.arange(bits - 1, -1, -1)
    bit_mat = ((codes[:, :, None].astype(np.int32) >> shifts[None, None])
               & 1).astype(np.uint8).reshape(lanes.shape[0],
                                             (spb - 1) * bits)
    packed = np.packbits(bit_mat, axis=1)
    blocks = np.concatenate([header, packed], axis=1).reshape(b, -1)
    return np.concatenate(
        [blocks, np.zeros((b, ADPCM_N_PAD[bits]), np.uint8)], axis=1)


def _adpcm_n_split(buf: np.ndarray, bits: int, block_align: int):
    """(B, adpcm_n_bytes(S, bits)) uint8 -> (pred0, index0, codes
    (lanes, spb-1) int32)."""
    b = buf.shape[0]
    nbl = buf.shape[1] // block_align
    blocks = buf[:, :nbl * block_align].reshape(-1, block_align)
    pred = (blocks[:, 0].astype(np.int32)
            | (blocks[:, 1].astype(np.int32) << 8))
    pred = np.where(pred >= 32768, pred - 65536, pred)
    index = np.clip(blocks[:, 2].astype(np.int32), 0, 88)
    data = blocks[:, 4:]
    spb = adpcm_n_samples_per_block(bits, block_align)
    bit_mat = np.unpackbits(data, axis=1).reshape(
        blocks.shape[0], spb - 1, bits).astype(np.int32)
    codes = np.zeros((blocks.shape[0], spb - 1), np.int32)
    for k in range(bits):
        codes = (codes << 1) | bit_mat[:, :, k]
    return pred, index, codes, b, nbl


def adpcm_n_decode_np(buf: np.ndarray, samples: int, bits: int,
                      block_align: int = ADPCM_BLOCK_ALIGN) -> np.ndarray:
    """Host-side reference decode -> float32 (B, samples) in [-1, 1)
    (the engine decodes on device: ``ops/wire._adpcm_decode``)."""
    assert bits in (2, 3), bits
    pred, index, codes, b, nbl = _adpcm_n_split(buf, bits, block_align)
    spb = adpcm_n_samples_per_block(bits, block_align)
    itab = adpcm_index_table(bits)
    steps = IMA_STEP_TABLE
    sign_bit = 1 << (bits - 1)
    out = np.empty((pred.shape[0], spb), np.int32)
    out[:, 0] = pred
    for t in range(spb - 1):
        n = codes[:, t]
        step = steps[index]
        diff = step >> (bits - 1)
        for k in range(bits - 2, -1, -1):
            diff = diff + np.where(n & (1 << k), step >> (bits - 2 - k),
                                   0)
        pred = np.clip(np.where(n & sign_bit, pred - diff, pred + diff),
                       -32768, 32767)
        out[:, t + 1] = pred
        index = np.clip(index + itab[n], 0, 88)
    out = out.reshape(b, nbl * spb)[:, :samples]
    return (out / 32768.0).astype(np.float32)
