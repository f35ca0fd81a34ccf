"""Fused log-mel: the wrapper of the CUDA kernel ``csrc/logmel.cu``
(counterpart of the Pallas kernel ``sed_tpu/ops/logmel_kernel.py``).

``fused_logmel(wav, cfg)`` takes (B, samples) float32 and returns
(B, T, mel_bins) log-mel.  A CPU tensor goes to the plain version,
``logmel_plain``.  A CUDA tensor launches the kernel, or raises: there is
no fallback.  The kernel reads frames straight from the center-padded
waveform, so the overlapped frames are never materialised.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sed_tpu_torch import _build
from sed_tpu_torch.dsp.frontend import (center_pad, frontend_matrices,
                                        logmel_plain)

_MEL_BINS = 64      # the kernel's mel accumulator width
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
    [ctypes.c_float] * 2 + [ctypes.c_void_p]


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
    padded = (center_pad(wav, n_fft, cfg.pad_mode) if cfg.center
              else wav).contiguous()
    batch, l_pad = padded.shape
    n_frames = 1 + (l_pad - n_fft) // hop
    if n_frames <= 0:
        raise ValueError(f'{wav.shape[1]} samples hold no {n_fft}-sample '
                         'frame')
    stft_mat, mel_mat = frontend_matrices(cfg, wav.device)
    assert stft_mat.is_contiguous() and mel_mat.is_contiguous()
    out = torch.empty((batch, n_frames, _MEL_BINS), dtype=torch.float32,
                      device=wav.device)
    kl = _library()
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        rc = kl.lib.sed_logmel_f32(
            padded.data_ptr(), stft_mat.data_ptr(), mel_mat.data_ptr(),
            out.data_ptr(), batch, l_pad, n_frames, n_fft, hop,
            n_fft // 2 + 1, cfg.amin,
            float(10.0 * np.log10(max(cfg.amin, cfg.ref))), stream)
    if rc != 0:
        raise RuntimeError(f'logmel kernel launch failed: '
                           f'{kl.error_string(rc)} ({rc})')
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0
