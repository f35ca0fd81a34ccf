"""Fused log-mel: the wrapper of the CUDA kernel ``csrc/logmel.cu``
(counterpart of the Pallas kernel ``sed_tpu/ops/logmel_kernel.py``).

``fused_logmel(wav, cfg)`` takes (B, samples) float32 and returns
(B, T, mel_bins) log-mel.  A CPU tensor goes to the plain version,
``logmel_plain``.  A CUDA tensor launches the kernel, or raises: there is
no fallback.  The kernel reads frames straight from the center-padded
waveform, so the overlapped frames are never materialised.

The kernel runs the DFT on the fp64 tensor cores (exact products of the
fp32 operands, fp64 sums) and the mel product in 3xTF32.  Its constant
operands are laid out here, once per (cfg, device), by
``kernel_operands``; the CPU tests read them back from the same function:

* ``pack_dft``: the (n_fft, 2*bins) [cos | sin] matrix packed to
  (n_fft, n_fft).  Per group of 8 bins: their 8 cosine columns, then
  their 8 sine columns.  The sine of bin 0 is zero for real frames, so its
  slot carries the cosine of bin n_fft/2 (whose sine is zero too).
* ``dft_tiles``: the packed matrix in fp64, in the order of the kernel's
  mma fragments, so that one 16-byte load gives a lane its operands.
* ``split_tf32``: x = hi + lo, both rounded to TF32 as ``cvt.rna`` does;
  ``mel_tiles``: the mel matrix's hi and lo in fragment order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sed_tpu_torch import _build
from sed_tpu_torch.dsp.frontend import (center_pad, frontend_matrices,
                                        logmel_plain)

_MEL_BINS = 64      # the kernel's mel accumulator width
_CHUNK_COLS = 128   # packed DFT columns per chunk (logmel.cu kChunkCols)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
    [ctypes.c_float] * 2 + [ctypes.c_void_p]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 value (10 mantissa bits), ties away from
    zero: ``cvt.rna.tf32.f32``, on the int32 view."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo (to 2^-22 relative), hi and lo TF32 values."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def pack_dft(stft_mat: torch.Tensor) -> torch.Tensor:
    """(n_fft, 2*(n_fft/2+1)) [cos | sin] -> (n_fft, n_fft) packed."""
    n = stft_mat.shape[0]
    h = n // 2
    cos, sin = stft_mat[:, :h + 1], stft_mat[:, h + 1:]
    packed = torch.stack([cos[:, :h].reshape(n, h // 8, 8),
                          sin[:, :h].reshape(n, h // 8, 8)], dim=2)
    packed = packed.reshape(n, n).clone()
    packed[:, 8] = cos[:, h]
    return packed


def dft_tiles(packed: torch.Tensor) -> torch.Tensor:
    """Packed (n, n) -> float64 in fragment order
    [chunk, k-step, n8 tile, g, t, (k t, k t+4)]: row k = 8*kstep + 4*q + t,
    column 128*chunk + 8*tile + g, lane 4*g + t."""
    n = packed.shape[0]
    w = packed.to(torch.float64).reshape(n // 8, 2, 4, n // _CHUNK_COLS,
                                         _CHUNK_COLS // 8, 8)
    return w.permute(3, 0, 4, 5, 2, 1).contiguous()


def mel_tiles(mel_mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mel rows of bins 0..n_fft/2-1 -> (hi/lo in fragment order
    [bin group, mel n8 tile, g, t, (hi, lo), (bin 2t, bin 2t+1)], uint8
    mask of the mel tiles of each bin group that are not all zero)."""
    h = mel_mat.shape[0] - 1
    mel = mel_mat[:h]
    w = torch.stack(split_tf32(mel)).reshape(2, h // 8, 4, 2,
                                             _MEL_BINS // 8, 8)
    nonzero = (mel.reshape(h // 8, 8, _MEL_BINS // 8, 8) != 0).any(3).any(1)
    mask = (nonzero.to(torch.int32) << torch.arange(8)).sum(1)
    return w.permute(1, 4, 5, 2, 0, 3).contiguous(), mask.to(torch.uint8)


class KernelOperands(NamedTuple):
    dft: torch.Tensor        # dft_tiles(pack_dft(stft)), n_fft^2 float64
    mel: torch.Tensor        # mel_tiles(mel)[0]
    mel_mask: torch.Tensor   # mel_tiles(mel)[1], (n_fft / 16,) uint8
    mel_nyq: torch.Tensor    # (64,) mel weights of bin n_fft/2


@functools.lru_cache(maxsize=8)
def kernel_operands(cfg, device: torch.device) -> KernelOperands:
    """The kernel's constant operands for ``cfg``, on ``device``."""
    stft_mat, mel_mat = frontend_matrices(cfg, torch.device('cpu'))
    mel, mask = mel_tiles(mel_mat)
    ops = KernelOperands(dft_tiles(pack_dft(stft_mat)), mel, mask,
                         mel_mat[cfg.window_size // 2].clone())
    return KernelOperands(*(x.to(device) for x in ops))


@functools.lru_cache(maxsize=None)
def _library() -> _build.KernelLibrary:
    kl = _build.load('logmel')
    fn = kl.lib.sed_logmel_f32
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES
    return kl


def fused_logmel(wav: torch.Tensor, cfg) -> torch.Tensor:
    """(B, samples) -> (B, T, mel_bins) log-mel, through the CUDA kernel
    for a CUDA tensor and ``logmel_plain`` for a CPU tensor.

    ``fused_logmel.launches`` counts kernel launches.
    """
    if cfg.top_db is not None:
        raise ValueError('fused_logmel does not implement the top_db clamp; '
                         'use logmel_plain for configs with top_db set')
    if wav.device.type == 'cpu':
        return logmel_plain(wav, cfg)
    if wav.device.type != 'cuda':
        raise ValueError(f'fused_logmel: unsupported device {wav.device}')
    if wav.dtype != torch.float32 or wav.dim() != 2:
        raise ValueError(f'fused_logmel wants (B, samples) float32, got '
                         f'{tuple(wav.shape)} {wav.dtype}')
    if not wav.is_contiguous():
        raise ValueError('fused_logmel wants a contiguous waveform')
    if cfg.mel_bins != _MEL_BINS:
        raise ValueError(f'the kernel computes {_MEL_BINS} mel bins, '
                         f'cfg has {cfg.mel_bins}')
    n_fft, hop = cfg.window_size, cfg.hop_size
    if n_fft % _CHUNK_COLS or hop % 8:
        raise ValueError(f'the kernel needs n_fft % {_CHUNK_COLS} == 0 and '
                         f'hop % 8 == 0, cfg has {n_fft} and {hop}')
    padded = center_pad(wav, n_fft, cfg.pad_mode) if cfg.center else wav
    batch, l_pad = padded.shape
    n_frames = 1 + (l_pad - n_fft) // hop
    if n_frames <= 0:
        raise ValueError(f'{wav.shape[1]} samples hold no {n_fft}-sample '
                         'frame')
    # the kernel copies 16-byte pieces: rows of a multiple of 4 floats,
    # zeros past the padded clip (read only by frames it does not write)
    if l_pad % 4:
        padded = F.pad(padded, (0, -l_pad % 4))
    padded = padded.contiguous()
    ops = kernel_operands(cfg, wav.device)
    out = torch.empty((batch, n_frames, _MEL_BINS), dtype=torch.float32,
                      device=wav.device)
    kl = _library()
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        rc = kl.lib.sed_logmel_f32(
            padded.data_ptr(), ops.dft.data_ptr(), ops.mel.data_ptr(),
            ops.mel_mask.data_ptr(), ops.mel_nyq.data_ptr(), out.data_ptr(),
            batch, padded.shape[1], n_frames, n_fft, hop, cfg.amin,
            float(10.0 * np.log10(max(cfg.amin, cfg.ref))), stream)
    if rc != 0:
        raise RuntimeError(f'logmel kernel launch failed: '
                           f'{kl.error_string(rc)} ({rc})')
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0
