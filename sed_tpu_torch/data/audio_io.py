"""Audio file I/O and the uint8 wire codecs (a copy of
``sed_tpu/data/audio_io.py``, in its order, numpy verbatim).

Wav decode is scipy-based, resampling polyphase (scipy), and ffmpeg an
optional fallback for compressed formats, as in ``sed_tpu``.  The wire
sections hold every codec of the serving wires: G.711 mu-law, the
block-scaled qN rungs and their ``.qN`` containers, the lossless
variable-rate v6 re-pack of q6 (whose section comment is the format's
specification), IMA ADPCM at 4, 3 and 2 bits and their wav / ``.adpcmN``
containers, and the file readers that hand the engine a clip's raw wire
bytes (``wire_reader_for``).  The engine decodes every wire on the device
(``ops/wire.py``); the numpy decoders here are its references.
``adpcm_encode`` / ``adpcm_n_encode`` run the port's native encoder
(``native/adpcm_native.py``, g++ at first use) and fall back to the
bit-exact numpy ``*_encode_np`` where it cannot be built.

Figures quoted below from ``sed_tpu``'s comments (clip sizes, event
matches, encoder speeds) are ``sed_tpu``'s own measurements on its host,
not the port's.
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


def load_wav_int16(path: str) -> Tuple[np.ndarray, int]:
    """Load a 16-bit PCM wav without float conversion (the serving engine
    dequantizes on device, halving host->device traffic)."""
    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype != np.int16:
        x = _to_float32(data)
        if x.ndim == 2:
            x = x.mean(axis=1)
        return (np.clip(x, -1, 1) * 32767.0).astype(np.int16), int(sr)
    if data.ndim == 2:
        data = data.mean(axis=1).astype(np.int16)
    return data, int(sr)


def fast_read_wav_int16(path: str) -> Tuple[np.ndarray, int]:
    """Minimal RIFF parser for canonical 16-bit PCM mono wav files.

    ~20x faster than the general scipy path for small clips (serving-path
    hot loop); falls back to ``load_wav_int16`` for anything non-canonical.
    """
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:4] != b'RIFF' or buf[8:12] != b'WAVE':
        return load_wav_int16(path)
    pos = 12
    sr = None
    channels = 1
    bits = 16
    while pos + 8 <= len(buf):
        chunk_id = buf[pos:pos + 4]
        size = int.from_bytes(buf[pos + 4:pos + 8], 'little')
        if chunk_id == b'fmt ':
            fmt = int.from_bytes(buf[pos + 8:pos + 10], 'little')
            channels = int.from_bytes(buf[pos + 10:pos + 12], 'little')
            sr = int.from_bytes(buf[pos + 12:pos + 16], 'little')
            bits = int.from_bytes(buf[pos + 22:pos + 24], 'little')
            if fmt != 1 or bits != 16:
                return load_wav_int16(path)
        elif chunk_id == b'data':
            if sr is None:            # data before/without fmt: punt
                return load_wav_int16(path)
            data = np.frombuffer(buf, np.int16, count=size // 2,
                                 offset=pos + 8)
            if channels > 1:
                data = data.reshape(-1, channels).mean(axis=1) \
                    .astype(np.int16)
            return data, int(sr)
        pos += 8 + size + (size & 1)
    return load_wav_int16(path)


# ---------------------------------------------------------------------------
# G.711 mu-law wire format (8 bits/sample)
#
# int16 PCM costs 160 KB per 5 s clip at 16 kHz.  Standard G.711 mu-law
# halves that; the engine dequantizes on device with a 256-entry table
# lookup.  This is the telephony wire format, so .wav files with
# format tag 7 (e.g. ffmpeg -acodec pcm_mulaw) are read without
# transcoding.
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


def save_wav_mulaw(path: str, x: np.ndarray, sr: int) -> None:
    """Write audio as a standard mu-law wav (format tag 7, 8 bits)."""
    data = mulaw_encode(np.asarray(x)).tobytes()
    n = len(data)
    with open(path, 'wb') as f:
        f.write(b'RIFF' + (36 + n).to_bytes(4, 'little') + b'WAVE')
        f.write(b'fmt ' + (16).to_bytes(4, 'little'))
        f.write((7).to_bytes(2, 'little'))          # WAVE_FORMAT_MULAW
        f.write((1).to_bytes(2, 'little'))          # mono
        f.write(int(sr).to_bytes(4, 'little'))
        f.write(int(sr).to_bytes(4, 'little'))      # byte rate
        f.write((1).to_bytes(2, 'little'))          # block align
        f.write((8).to_bytes(2, 'little'))          # bits per sample
        f.write(b'data' + n.to_bytes(4, 'little'))
        f.write(data)


def fast_read_wav_mulaw(path: str) -> Tuple[np.ndarray, int]:
    """Read a mu-law wav as raw uint8 codes (no transcoding — the engine
    dequantizes on device).  Falls back to encoding from the PCM reader
    for non-mu-law files."""
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:4] == b'RIFF' and buf[8:12] == b'WAVE':
        pos = 12
        sr = None
        fmt = None
        while pos + 8 <= len(buf):
            chunk_id = buf[pos:pos + 4]
            size = int.from_bytes(buf[pos + 4:pos + 8], 'little')
            if chunk_id == b'fmt ':
                fmt = int.from_bytes(buf[pos + 8:pos + 10], 'little')
                channels = int.from_bytes(buf[pos + 10:pos + 12], 'little')
                sr = int.from_bytes(buf[pos + 12:pos + 16], 'little')
            elif chunk_id == b'data' and fmt == 7 and channels == 1:
                return (np.frombuffer(buf, np.uint8, count=size,
                                      offset=pos + 8), int(sr))
            elif chunk_id == b'data':
                break
            pos += 8 + size + (size & 1)
    pcm, sr = fast_read_wav_int16(path)
    return mulaw_encode(pcm), sr


# ---------------------------------------------------------------------------
# qN wire formats: N-bit block-scaled quantization (N in {4, 5, 6})
#
# Bandwidth-lean serving wires: 128-sample blocks, signed N-bit mantissas
# packed big-endian against a per-block float16 scale, scales appended to
# the same uint8 buffer (one array per clip, so the engine's batch
# plumbing is format agnostic).  Per 5 s clip at 16 kHz: q2 21.25 KB, q3
# 31.25 KB, q4 41.25 KB, q5 51.25 KB, q6 61.25 KB vs 80 KB mu-law /
# 160 KB int16.  ``sed_tpu`` pins their event match against int16 on the bench
# distribution with the trained checkpoint
# (tests/test_wire.py::test_narrow_wire_event_match_trained): q6 is
# event-identical, q5 and q4 lose some events, q3 / q2 degrade detection
# outright and exist only as wires where that is an explicit trade.
# Device decode: two byte-gathers + shift/mask + one multiply — the
# same static-slice formulation for every width (sample bit offsets
# repeat every lcm(8, bits) bits).
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


def q4_bytes(samples: int) -> int:
    return qn_bytes(samples, 4)


def q4_encode(x: np.ndarray) -> np.ndarray:
    return qn_encode(x, 4)


def q4_decode_np(buf: np.ndarray, samples: int) -> np.ndarray:
    return qn_decode_np(buf, samples, 4)


def save_qn(path: str, x: np.ndarray, sr: int, bits: int) -> None:
    """Write one clip as a .qN container (sed_tpu's packed serving
    format: 13-byte header + qN wire bytes).  Header version byte 1 is
    the legacy 4-bit container; otherwise it names the bit width."""
    x = np.asarray(x)
    buf = qn_encode(x[None], bits)[0]
    with open(path, 'wb') as f:
        f.write(b'SEDQ' + bytes([1 if bits == 4 else bits]))
        f.write(int(sr).to_bytes(4, 'little'))
        f.write(int(x.shape[-1]).to_bytes(4, 'little'))
        f.write(buf.tobytes())


def read_qn(path: str) -> Tuple[np.ndarray, int, int]:
    """Read a .qN container -> (wire uint8 codes, sample_rate, samples).
    The codes feed the engine directly (device-side decode)."""
    with open(path, 'rb') as f:
        head = f.read(13)
        assert head[:4] == b'SEDQ', f'not a qN file: {path}'
        bits = 4 if head[4] == 1 else head[4]
        assert bits in QN_BITS, f'unknown qN bit width {bits}: {path}'
        sr = int.from_bytes(head[5:9], 'little')
        samples = int.from_bytes(head[9:13], 'little')
        return (np.frombuffer(f.read(qn_bytes(samples, bits)), np.uint8),
                sr, samples)


def save_q4(path: str, x: np.ndarray, sr: int) -> None:
    save_qn(path, x, sr, 4)


def read_q4(path: str) -> Tuple[np.ndarray, int, int]:
    return read_qn(path)


# ---------------------------------------------------------------------------
# v6: LOSSLESS variable-rate re-pack of the q6 wire.
#
# The q6 container is the narrowest wire whose decode is event-EXACT vs
# the int16 baseline (the fidelity ladder's last exact rung in
# ``sed_tpu``'s measurements).  Its 6-bit symbols are block-max
# normalized, so they always span the full +-31 range — amplitude coding
# saves nothing — but they are temporally PREDICTABLE for tonal/smooth
# content.  v6
# stores, per 128-sample block, the residual of the best of four
# predictors (Shorten-style fixed orders 0/1/2 plus a per-block
# quantized-coefficient order-2 LPC), packed at the narrowest signed
# bit width that holds each 32-sample SUB-GROUP (width adaptation at
# 1/4-block granularity: residual maxima, not means, set fixed-width
# cost).  Order 0 / width 6 is the escape, so v6 is never more than
# the header overhead (~7 B/block) above q6 and reconstructs the EXACT
# q6 symbol stream by construction (bit-identical decode, event match
# 1.00 vs q6).  This replaces the reference's 160 KB/clip int16 host
# round-trip (``pytorch/predict.py:295-313``).
#
# The size depends only on the audio.  ``sed_tpu`` reports ~59 KB/clip
# against q6's 61.25 on its bench corpus, whose coloured and white noise
# backgrounds are near-incompressible by design, and < 20 KB on pure
# tones; ``chip_smoke.py`` phase 18 measures the port's bench-corpus
# payloads again.
#
# Per-clip layout (little-endian, nb = samples/128 blocks, 4
# sub-groups of 32 samples per block):
#   [0)      f16 block scales     2*nb B  (bit-identical to q6's)
#   [2nb)    mode u16 per block   2*nb B  bits [0:2]=order, [2:5]=w0,
#                                         [5:8]=w1, [8:11]=w2,
#                                         [11:14]=w3, [14:16]=0
#   [4nb)    init1 int8           nb B    predictor warm-up q_{-1}
#   [5nb)    init2 int8           nb B    predictor warm-up q_{-2}
#   [6nb)    coef int8            nb B    order-3 LPC coefficient a
#   pad to 16 B                           -> v6_header_bytes(nb)
#   data     4*w_g bytes per sub-group in (block, sub-group) order:
#            32 residual codes at w_g bits, big-endian bitstream (the
#            qN packing), code = residual + 2^(w-1); w=0 ships nothing
#   pad to 16 B
#
# Blocks are SELF-CONTAINED (warm-up state stored, no cross-block
# dependency), so the device decode is fully block-parallel: one CUDA
# kernel launch (csrc/v6_decode.cu) reads each chunk's words at cumsum(w)
# offsets, unpacks them in shared memory and runs the 128-step unified
# recurrence, one thread per (clip, block) lane.  See
# ops/wire.dequant_v6_pool.
#
# Predictor definitions (int32 arithmetic, exact; q_{-1}=init1,
# q_{-2}=init2):
#   order 0: pred_i = 0                  (raw symbols; the escape)
#   order 1: pred_i = q_{i-1}            (init1 = q_0 -> r_0 = 0)
#   order 2: pred_i = 2 q_{i-1} - q_{i-2}
#            init1 = clip8(2 q_0 - q_1), init2 = clip8(3 q_0 - 2 q_1)
#   order 3: pred_i = ((a q_{i-1} + 16) >> 5) - q_{i-2}   (LPC; a is
#            minimax-refined around the block autocorrelation fit —
#            2cos(w)*32 for a pure tone at any frequency)
#            init1 = q_0, init2 = clip8(((a q_0 + 16) >> 5) - q_0)
#   r_i = q_i - pred_i; exactness never depends on the warm-up choice
#   (the stored init is what the decoder uses).
# ---------------------------------------------------------------------------

V6_BITS = 6          # the exact-parity qN rung v6 re-packs
_V6_TOP = (1 << (V6_BITS - 1)) - 1
V6_SUB = 32          # width-adaptation granularity (samples)
_V6_NSUB = Q4_BLOCK // V6_SUB


def v6_header_bytes(n_blocks: int) -> int:
    return -(-(7 * n_blocks) // 16) * 16


def v6_max_bytes(samples: int) -> int:
    """Worst-case v6 payload (every sub-group at width 6): the static
    device buffer bound and the encoder's guaranteed ceiling."""
    assert samples % Q4_BLOCK == 0, samples
    nb = samples // Q4_BLOCK
    return v6_header_bytes(nb) + nb * 16 * V6_BITS


def _v6_sub_widths(r: np.ndarray) -> np.ndarray:
    """(nb, 128) int residuals -> (nb, 4) minimal signed bit width per
    32-sample sub-group: w such that every r fits
    [-2^(w-1), 2^(w-1)-1]; 0 iff all-zero; 99 if > 6 bits needed."""
    rs = r.reshape(r.shape[0], _V6_NSUB, V6_SUB)
    mx = rs.max(axis=2)
    mn = rs.min(axis=2)
    m = np.maximum(mx, -mn - 1)
    w = np.full(m.shape, 99, np.int32)
    for k in range(V6_BITS, 0, -1):
        w = np.where(m <= (1 << (k - 1)) - 1, k, w)
    return np.where((mx == 0) & (mn == 0), 0, w).astype(np.int32)


def _v6_pack_width(codes: np.ndarray, w: int) -> np.ndarray:
    """(k, 32) codes < 2^w -> (k, 4*w) uint8 big-endian bitstream
    (identical packing to the qN wire)."""
    shifts = np.arange(w - 1, -1, -1)
    bits = ((codes[:, :, None] >> shifts[None, None, :]) & 1).astype(
        np.uint8).reshape(codes.shape[0], V6_SUB * w)
    return np.packbits(bits, axis=1)


def _v6_unpack_width(data: np.ndarray, w: int) -> np.ndarray:
    """(..., 4*w) uint8 -> (..., 32) int32 codes (host reference)."""
    nb_ = 4 * w
    d = data.astype(np.int32)
    bitpos = np.arange(V6_SUB) * w
    j = bitpos >> 3
    sh = 16 - w - (bitpos & 7)
    lo = d[..., np.minimum(j + 1, nb_ - 1)]
    return (((d[..., j] << 8) | lo) >> sh) & ((1 << w) - 1)


def _v6_symbols(x: np.ndarray):
    """One clip -> (q int32 (nb, 128) in [-32, 31], scale f16 (nb,)),
    EXACTLY as ``qn_encode(x[None], 6)`` derives them."""
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32767.0
    x = np.asarray(x, np.float32)
    blocks = x.reshape(-1, Q4_BLOCK)
    scale = np.maximum(np.abs(blocks).max(axis=1) / _V6_TOP,
                       1e-6).astype(np.float16)
    q = np.clip(np.round(blocks / scale.astype(np.float32)[:, None]),
                -_V6_TOP - 1, _V6_TOP).astype(np.int32)
    return q, scale


def _v6_lpc_residual(q: np.ndarray, a: np.ndarray):
    """Order-3 residuals for coefficient a: (r, init1, init2)."""
    q0 = q[:, 0]
    init1 = q0
    init2 = np.clip(((a * q0 + 16) >> 5) - q0, -128, 127)
    r = np.empty_like(q)
    r[:, 0] = q0 - (((a * init1 + 16) >> 5) - init2)
    r[:, 1] = q[:, 1] - (((a * q0 + 16) >> 5) - init1)
    r[:, 2:] = q[:, 2:] - (((a[:, None] * q[:, 1:-1] + 16) >> 5)
                           - q[:, :-2])
    return r, init1, init2


def v6_encode_clip(x: np.ndarray) -> np.ndarray:
    """float [-1,1] or int16 (S,) -> variable-length uint8 wire (length
    a multiple of 16; <= v6_max_bytes(S))."""
    q, scale = _v6_symbols(x)
    nb = q.shape[0]

    # order-1 residuals: init1 = q_0 -> r_0 = 0
    r1 = np.concatenate([np.zeros((nb, 1), np.int32),
                         np.diff(q, axis=1)], axis=1)
    # order-2 residuals with backward-extrapolated warm-up state
    q0, q1 = q[:, 0], q[:, 1]
    i1_2 = np.clip(2 * q0 - q1, -128, 127)
    i2_2 = np.clip(3 * q0 - 2 * q1, -128, 127)
    r2 = np.empty_like(q)
    r2[:, 0] = q0 - (2 * i1_2 - i2_2)
    r2[:, 1] = q1 - (2 * q0 - i1_2)
    r2[:, 2:] = q[:, 2:] - 2 * q[:, 1:-1] + q[:, :-2]
    # order-3 LPC: autocorrelation fit, minimax-refined (the width is
    # set by the residual MAX, not its variance)
    qf = q.astype(np.float64)
    num = (qf[:, 1:-1] * (qf[:, 2:] + qf[:, :-2])).sum(axis=1)
    den = (qf[:, 1:-1] ** 2).sum(axis=1) + 1e-9
    a0 = np.clip(np.round(32.0 * num / den), -127, 127).astype(np.int32)
    best_a, best_m = a0, None
    for d in range(-8, 9, 2):
        a = np.clip(a0 + d, -127, 127)
        rl_, _, _ = _v6_lpc_residual(q, a)
        m = np.abs(rl_).max(axis=1)
        if best_m is None:
            best_a, best_m = a, m
        else:
            upd = m < best_m
            best_a = np.where(upd, a, best_a)
            best_m = np.where(upd, m, best_m)
    r3, i1_3, i2_3 = _v6_lpc_residual(q, best_a)

    # choose per block: min data bytes (sum of sub-group widths),
    # ties -> lower order
    order = np.zeros(nb, np.int32)
    width = np.full((nb, _V6_NSUB), V6_BITS, np.int32)
    cost = width.sum(axis=1)
    for o, r in ((1, r1), (2, r2), (3, r3)):
        w = _v6_sub_widths(r)
        c = w.sum(axis=1)
        take = (c < cost) & (w.max(axis=1) <= V6_BITS)
        order[take] = o
        width[take] = w[take]
        cost = np.where(take, c, cost)

    init1 = np.select([order == 1, order == 2, order == 3],
                      [q0, i1_2, i1_3], 0)
    init2 = np.select([order == 2, order == 3], [i2_2, i2_3], 0)
    coef = np.where(order == 3, best_a, 0)
    r = np.select([order[:, None] == 1, order[:, None] == 2,
                   order[:, None] == 3], [r1, r2, r3], q)
    half = np.where(width > 0, 1 << np.maximum(width - 1, 0), 0)
    codes = (r.reshape(nb, _V6_NSUB, V6_SUB)
             + half[:, :, None]).reshape(nb * _V6_NSUB, V6_SUB)

    hb = v6_header_bytes(nb)
    wflat = width.reshape(-1)
    dlen = 4 * wflat
    doff = hb + np.concatenate([[0], np.cumsum(dlen)[:-1]])
    total = -(-(hb + int(dlen.sum())) // 16) * 16
    out = np.zeros(total, np.uint8)
    out[:2 * nb] = scale.view(np.uint8)
    mode = (order | (width[:, 0] << 2) | (width[:, 1] << 5)
            | (width[:, 2] << 8) | (width[:, 3] << 11)).astype(np.uint16)
    out[2 * nb:4 * nb] = mode.view(np.uint8)
    out[4 * nb:5 * nb] = init1.astype(np.int8).view(np.uint8)
    out[5 * nb:6 * nb] = init2.astype(np.int8).view(np.uint8)
    out[6 * nb:7 * nb] = coef.astype(np.int8).view(np.uint8)
    for w in range(1, V6_BITS + 1):
        sel = wflat == w
        if not sel.any():
            continue
        packed = _v6_pack_width(codes[sel], w)
        dst = doff[sel][:, None] + np.arange(4 * w)[None, :]
        out[dst.ravel()] = packed.ravel()
    return out


def v6_decode_np(buf: np.ndarray, samples: int) -> np.ndarray:
    """Host reference decode of one clip's v6 wire -> (samples,)
    float32, BIT-IDENTICAL to ``qn_decode_np(qn_encode(x[None], 6),
    samples, 6)[0]`` (the engine decodes on device)."""
    nb = samples // Q4_BLOCK
    hb = v6_header_bytes(nb)
    buf = np.asarray(buf, np.uint8)
    scale = np.frombuffer(buf[:2 * nb].tobytes(), np.float16).astype(
        np.float32)
    mode = np.frombuffer(buf[2 * nb:4 * nb].tobytes(),
                         np.uint16).astype(np.int32)
    order = mode & 3
    width = np.stack([(mode >> (2 + 3 * g)) & 7
                      for g in range(_V6_NSUB)], axis=1)
    init1 = buf[4 * nb:5 * nb].view(np.int8).astype(np.int32)
    init2 = buf[5 * nb:6 * nb].view(np.int8).astype(np.int32)
    coef = buf[6 * nb:7 * nb].view(np.int8).astype(np.int32)
    wflat = width.reshape(-1)
    doff = hb + np.concatenate([[0], np.cumsum(4 * wflat)[:-1]])

    r = np.zeros((nb * _V6_NSUB, V6_SUB), np.int32)
    for w in range(1, V6_BITS + 1):
        sel = np.nonzero(wflat == w)[0]
        if sel.size == 0:
            continue
        idx = doff[sel][:, None] + np.arange(4 * w)[None, :]
        codes = _v6_unpack_width(buf[idx], w)
        r[sel] = codes - (1 << (w - 1))
    r = r.reshape(nb, Q4_BLOCK)

    q = np.empty((nb, Q4_BLOCK), np.int32)
    qp, qp2 = init1, init2
    for t in range(Q4_BLOCK):
        pred = np.select(
            [order == 1, order == 2, order == 3],
            [qp, 2 * qp - qp2, ((coef * qp + 16) >> 5) - qp2], 0)
        q[:, t] = r[:, t] + pred
        qp2 = qp
        qp = q[:, t]
    return (q.astype(np.float32) * scale[:, None]).reshape(samples)


def save_v6(path: str, x: np.ndarray, sr: int) -> None:
    """Write one clip as a .v6 container (13-byte header matching the
    qN container layout: magic + bits + sr + samples, then the
    variable-length payload)."""
    x = np.asarray(x)
    buf = v6_encode_clip(x)
    with open(path, 'wb') as f:
        f.write(b'SEDV' + bytes([V6_BITS]))
        f.write(int(sr).to_bytes(4, 'little'))
        f.write(int(x.shape[-1]).to_bytes(4, 'little'))
        f.write(buf.tobytes())


def read_v6(path: str) -> Tuple[np.ndarray, int, int]:
    """Read a .v6 container -> (wire uint8 payload, sample_rate,
    samples).  The payload feeds the engine's ragged resident path
    (device-side decode)."""
    with open(path, 'rb') as f:
        head = f.read(13)
        assert head[:4] == b'SEDV', f'not a v6 file: {path}'
        assert head[4] == V6_BITS, f'unknown v6 rung {head[4]}: {path}'
        sr = int.from_bytes(head[5:9], 'little')
        samples = int.from_bytes(head[9:13], 'little')
        return np.frombuffer(f.read(), np.uint8), sr, samples


def v6_payload_bytes(path: str) -> int:
    """Payload size of a .v6 container WITHOUT reading it (header is
    13 bytes) — the ragged resident path plans pool offsets from file
    sizes before any content is read."""
    return os.path.getsize(path) - 13


# ---------------------------------------------------------------------------
# IMA ADPCM wire (WAVE_FORMAT_IMA_ADPCM, tag 0x11): a TRUE standard wav
# codec at ~4.06 bits/sample — 33% narrower than the q6 container and a
# byte-exact match for files produced by `ffmpeg -acodec adpcm_ima_wav`.
#
# Block layout (mono, block_align `ba` bytes): 4-byte header (int16 LE
# predictor = sample 0, uint8 step index, reserved 0) + (ba-4)*2 nibbles
# (low nibble first), so samples_per_block = 2*(ba-4) + 1.  Blocks are
# independently decodable — the device decode resolves the spb-1-step
# recursions vectorized over every (clip, block) lane, so the
# sequential predictor recursion costs block-length, not clip-length.
#
# Differential coding buys ~2 bits of SNR over the block-scaled q4 wire
# at the same rate (q4 measurably costs ER on the bench distribution;
# see the qN section comment above).  Tables and the shift-add
# reconstruction follow the IMA/DVI-4 spec exactly (the truncating
# shift-add form, NOT the closed-form multiply, which differs by
# rounding) so any standard decoder bit-matches `adpcm_decode_np`.
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
    carry the raw blocks without the pad (``save_wav_adpcm``)."""
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


def adpcm_encode(x: np.ndarray,
                 block_align: int = ADPCM_BLOCK_ALIGN) -> np.ndarray:
    """float [-1,1] or int16 (B, S) -> (B, adpcm_bytes(S)) uint8.

    Dispatches to the native C++ encoder when available (bit-exact;
    the numpy encode's spb-1-step recursion is a Python loop over every
    sample of a block, which ``sed_tpu`` measured as its train wire's
    bottleneck), falling back to ``adpcm_encode_np``."""
    from sed_tpu_torch.native import adpcm_native
    if adpcm_native.native_available():
        if x.dtype != np.int16:
            x = np.clip(np.round(np.asarray(x, np.float32) * 32767.0),
                        -32768, 32767).astype(np.int16)
        return adpcm_native.encode(x, block_align)
    return adpcm_encode_np(x, block_align)


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


# ---------------------------------------------------------------------------
# Narrow ADPCM wires (adpcm3 / adpcm2): the IMA predictor + step-size
# adaptation at 3- and 2-bit code widths (the DVI/IMA spec's own
# lower-rate variants) in a sed_tpu block container.  ``sed_tpu``
# measured adpcm4 ER/F1-transparent on its bench corpus while q3 failed
# its admission test (segment ER/F1 against int16,
# tools/wire_admission.py): differential coding holds SNR where
# block-max quantizers lose segment decisions, so the rungs below adpcm4
# are its own narrower-code siblings: adpcm3 at 3.04 bits/sample and
# adpcm2 at 2.03.
#
# Block layout (block_align ba): the IMA 4-byte header (int16 LE
# predictor = sample 0, uint8 step index, reserved 0) + (ba-4) bytes of
# BIG-ENDIAN packed N-bit codes — spb = (ba-4)*8/N + 1 samples/block
# (673 / 1009 at ba=256 vs adpcm4's 505).  Codes: sign bit (1<<(N-1))
# + magnitude; reconstruction diff = step>>(N-1) + sum_k bit_k *
# (step>>k), the same truncating shift-add family as the 4-bit codec,
# so the device decode reuses the blocked clamp-add prefix resolution
# (ops/wire.py) unchanged.  Rows end with ADPCM_N_PAD[bits] zero bytes:
# widths are ≡ 1/3/5 (mod 8) for bits 4/3/2 while every qN/mu-law/int16
# width is even — the width-keyed wire dispatch stays collision-free.
# ---------------------------------------------------------------------------

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


def adpcm_n_encode(x: np.ndarray, bits: int,
                   block_align: int = ADPCM_BLOCK_ALIGN) -> np.ndarray:
    """Narrow-ADPCM encode, dispatching to the native C++ codec when
    available (bit-exact to ``adpcm_n_encode_np``; same motivation as
    ``adpcm_encode`` — the spb-1-step recursion is host-bound)."""
    from sed_tpu_torch.native import adpcm_native
    if adpcm_native.native_available():
        if x.dtype != np.int16:
            x = np.clip(np.round(np.asarray(x, np.float32) * 32767.0),
                        -32768, 32767).astype(np.int16)
        return adpcm_native.encode_n(x, bits, block_align)
    return adpcm_n_encode_np(x, bits, block_align)


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


def save_adpcm_n(path: str, x: np.ndarray, sr: int, bits: int) -> None:
    """Write one clip as a .adpcmN container (13-byte SEDA header +
    wire bytes, pad included — the payload feeds the engine directly,
    like ``save_qn``/``read_qn``)."""
    x = np.asarray(x)
    buf = adpcm_n_encode(x[None], bits)[0]
    with open(path, 'wb') as f:
        f.write(b'SEDA' + bytes([bits]))
        f.write(int(sr).to_bytes(4, 'little'))
        f.write(int(x.shape[-1]).to_bytes(4, 'little'))
        f.write(buf.tobytes())


def read_adpcm_n(path: str) -> Tuple[np.ndarray, int, int]:
    """Read a .adpcmN container -> (wire uint8, sample_rate, samples)."""
    with open(path, 'rb') as f:
        head = f.read(13)
        assert head[:4] == b'SEDA', f'not an adpcmN file: {path}'
        bits = head[4]
        assert bits in (2, 3), f'unknown adpcmN width {bits}: {path}'
        sr = int.from_bytes(head[5:9], 'little')
        samples = int.from_bytes(head[9:13], 'little')
        return (np.frombuffer(f.read(adpcm_n_bytes(samples, bits)),
                              np.uint8), sr, samples)


def save_wav_adpcm(path: str, x: np.ndarray, sr: int,
                   block_align: int = ADPCM_BLOCK_ALIGN) -> None:
    """Write audio as a standard IMA ADPCM wav (format tag 0x11)."""
    x = np.asarray(x)
    samples = int(x.shape[-1])
    spb = adpcm_samples_per_block(block_align)
    data = adpcm_encode(x[None], block_align)[0, :-1].tobytes()
    n = len(data)
    with open(path, 'wb') as f:
        f.write(b'RIFF' + (4 + 28 + 12 + 8 + n).to_bytes(4, 'little')
                + b'WAVE')
        f.write(b'fmt ' + (20).to_bytes(4, 'little'))
        f.write((0x11).to_bytes(2, 'little'))   # WAVE_FORMAT_IMA_ADPCM
        f.write((1).to_bytes(2, 'little'))      # mono
        f.write(int(sr).to_bytes(4, 'little'))
        f.write((int(sr) * block_align // spb).to_bytes(4, 'little'))
        f.write(int(block_align).to_bytes(2, 'little'))
        f.write((4).to_bytes(2, 'little'))      # bits per sample
        f.write((2).to_bytes(2, 'little'))      # cbSize
        f.write(int(spb).to_bytes(2, 'little'))  # wSamplesPerBlock
        f.write(b'fact' + (4).to_bytes(4, 'little'))
        f.write(samples.to_bytes(4, 'little'))
        f.write(b'data' + n.to_bytes(4, 'little'))
        f.write(data)


def fast_read_wav_adpcm(path: str) -> Tuple[np.ndarray, int, int, int]:
    """Read an IMA ADPCM wav's raw block bytes (no transcoding — the
    engine decodes on device) -> (uint8 blocks, sr, samples,
    block_align)."""
    with open(path, 'rb') as f:
        buf = f.read()
    assert buf[:4] == b'RIFF' and buf[8:12] == b'WAVE', path
    pos, sr, tag, ba, spb, samples = 12, None, None, None, None, None
    while pos + 8 <= len(buf):
        chunk_id = buf[pos:pos + 4]
        size = int.from_bytes(buf[pos + 4:pos + 8], 'little')
        if chunk_id == b'fmt ':
            tag = int.from_bytes(buf[pos + 8:pos + 10], 'little')
            channels = int.from_bytes(buf[pos + 10:pos + 12], 'little')
            sr = int.from_bytes(buf[pos + 12:pos + 16], 'little')
            ba = int.from_bytes(buf[pos + 20:pos + 22], 'little')
            assert tag == 0x11 and channels == 1, (tag, channels, path)
            if size >= 20:
                spb = int.from_bytes(buf[pos + 26:pos + 28], 'little')
        elif chunk_id == b'fact':
            samples = int.from_bytes(buf[pos + 8:pos + 12], 'little')
        elif chunk_id == b'data':
            assert tag == 0x11, f'no IMA ADPCM fmt chunk before data: {path}'
            if spb is None:
                spb = adpcm_samples_per_block(ba)
            nbl = size // ba
            if samples is None:
                samples = nbl * spb
            return (np.frombuffer(buf, np.uint8, count=nbl * ba,
                                  offset=pos + 8), int(sr),
                    int(samples), int(ba))
        pos += 8 + size + (size & 1)
    raise ValueError(f'no data chunk: {path}')


def get_duration(path: str) -> float:
    """Duration in seconds (librosa.get_duration on a file)."""
    x, sr = load_audio(path, sr=None, mono=True)
    return len(x) / float(sr)


def save_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write float32 [-1, 1] audio as 16-bit PCM wav."""
    data = np.clip(x, -1.0, 1.0)
    wavfile.write(path, sr, (data * 32767.0).astype(np.int16))


def trim_silent(x: np.ndarray, sr: int, top_db: float = 18.0,
                frame_length: int = 2048, hop_length: int = 512):
    """Split audio on silence (librosa.effects.split semantics): returns
    (non-silent intervals [[start, end), ...] in samples, concatenated
    non-silent audio).  Equivalent of the reference's unused helper
    (``pytorch/predict.py:40-55``)."""
    if len(x) < frame_length:
        rms = np.asarray([np.sqrt(np.mean(x ** 2) + 1e-12)])
    else:
        n = 1 + (len(x) - frame_length) // hop_length
        frames = np.lib.stride_tricks.as_strided(
            x, shape=(n, frame_length),
            strides=(x.strides[0] * hop_length, x.strides[0]))
        rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10))
    non_silent = db > (db.max() - top_db)
    idx = np.flatnonzero(non_silent)
    if idx.size == 0:
        return np.zeros((0, 2), np.int64), x[:0]
    gaps = np.flatnonzero(np.diff(idx) > 1)
    starts = idx[np.concatenate(([0], gaps + 1))] * hop_length
    ends = np.minimum(
        (idx[np.concatenate((gaps, [idx.size - 1]))] + 1) * hop_length
        + frame_length - hop_length, len(x))
    intervals = np.stack([starts, ends], axis=1)
    audio = np.concatenate([x[s:e] for s, e in intervals])
    return intervals, audio


def pad_truncate(x: np.ndarray, max_len: int) -> np.ndarray:
    """Zero-pad or truncate to ``max_len``
    (``utils/utilities.py:66-71``)."""
    if len(x) < max_len:
        return np.concatenate(
            (x, np.zeros(max_len - len(x), dtype=x.dtype)))
    return x[:max_len]


def _wav_format_tag(path: str) -> int:
    """Peek a RIFF wav's fmt-chunk format tag (1=PCM, 7=mu-law).
    Walks chunk headers with seeks, so arbitrarily large metadata
    chunks (LIST/bext) before ``fmt `` don't defeat the sniff.
    Returns 0 for non-RIFF files or when no fmt chunk exists."""
    with open(path, 'rb') as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b'RIFF' or head[8:12] != b'WAVE':
            return 0
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return 0
            if hdr[:4] == b'fmt ':
                tag = f.read(2)
                return int.from_bytes(tag, 'little') if len(tag) == 2 \
                    else 0
            size = int.from_bytes(hdr[4:8], 'little')
            f.seek(size + (size & 1), os.SEEK_CUR)


def wire_reader_for(path: str):
    """Pick the serving-wire reader for a corpus by sniffing one file:
    ``.q4/.q5/.q6`` containers -> qN codes, mu-law wav (format tag 7) ->
    raw G.711 codes, IMA ADPCM wav (format tag 0x11, default block
    align) -> raw block bytes, other wavs -> int16 PCM.  The returned
    ``reader(path) -> 1-D wire array`` feeds
    ``SedInferenceEngine.predict_files_resident`` (the engine
    dequantizes on device)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in ('.q4', '.q5', '.q6'):
        return lambda p: read_qn(p)[0]
    tag = _wav_format_tag(path)
    if tag == 7:
        return lambda p: fast_read_wav_mulaw(p)[0]
    if tag == 0x11:
        # device decode dispatches on buffer width computed from the
        # DEFAULT block align — reject off-default files loudly here
        # rather than mis-decoding downstream
        def read_adpcm(p):
            blocks, _, _, ba = fast_read_wav_adpcm(p)
            assert ba == ADPCM_BLOCK_ALIGN, (
                f'{p}: ADPCM block align {ba} != wire default '
                f'{ADPCM_BLOCK_ALIGN} (re-encode with save_wav_adpcm)')
            # odd-width wire pad byte (see adpcm_bytes)
            return np.concatenate([blocks, np.zeros(1, np.uint8)])
        return read_adpcm
    return lambda p: fast_read_wav_int16(p)[0]


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
