"""Log-mel frontend in plain PyTorch (counterpart of
``sed_tpu/dsp/frontend.py``).

    center pad -> frames (B, T, n_fft) -> @ DFT [cos|sin] -> re^2 + im^2
    -> @ mel (bins, 64) -> 10*log10(max(mel, amin)) - 10*log10(max(amin, ref))

librosa semantics as in the reference: center reflect (or constant)
padding, periodic Hann, power 2.0.  Everything runs in float32; the
products must not run in TF32 (a reduced-precision pass costs ~0.2 dB),
so on a GPU ``torch.backends.cuda.matmul.allow_tf32`` must be False.
``logmel_plain`` is the plain version of the CUDA kernel in
``sed_tpu_torch/ops/logmel_kernel.py`` and its CPU path.

Public functions take and return the JAX layout: (B, samples) in,
(B, T, mel_bins) out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sed_tpu_torch._host import filters


def center_pad(x: torch.Tensor, frame_length: int,
               pad_mode: str = 'reflect') -> torch.Tensor:
    """Pad ``frame_length // 2`` on both sides of the last axis
    (librosa center=True).  ``x``: (B, samples)."""
    pad = frame_length // 2
    if pad_mode == 'reflect':
        return F.pad(x, (pad, pad), mode='reflect')
    if pad_mode == 'constant':
        return F.pad(x, (pad, pad))
    raise ValueError(f'unsupported pad_mode: {pad_mode}')


def frame_signal(x: torch.Tensor, frame_length: int, hop_length: int,
                 center: bool = True,
                 pad_mode: str = 'reflect') -> torch.Tensor:
    """(B, samples) -> (B, n_frames, frame_length) overlapped frames, a
    strided view of the (padded) signal."""
    if center:
        x = center_pad(x, frame_length, pad_mode)
    return x.unfold(-1, frame_length, hop_length)


@functools.lru_cache(maxsize=8)
def frontend_matrices(cfg, device: torch.device):
    """(DFT (n_fft, 2*bins), mel (bins, mel_bins)) float32 row-major on
    ``device``, made by the function shared with ``sed_tpu`` (whose mel matrix
    is a column-major numpy array)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                 for m in filters.frontend_arrays(cfg))


def spectrogram(x: torch.Tensor, stft_mat: torch.Tensor, hop_length: int,
                center: bool = True,
                pad_mode: str = 'reflect') -> torch.Tensor:
    """Power spectrogram |STFT|^2, (B, T, n_fft // 2 + 1)."""
    n_fft = stft_mat.shape[0]
    frames = frame_signal(x, n_fft, hop_length, center, pad_mode)
    re_im = torch.matmul(frames, stft_mat)
    n_bins = n_fft // 2 + 1
    re, im = re_im[..., :n_bins], re_im[..., n_bins:]
    return re * re + im * im


def power_to_db(x: torch.Tensor, ref: float = 1.0, amin: float = 1e-10,
                top_db: float | None = None) -> torch.Tensor:
    """librosa.power_to_db; ``top_db`` clamps against the max over the
    whole tensor, as the reference does."""
    log_spec = 10.0 * torch.log10(torch.clamp(x, min=amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        if top_db < 0:
            raise ValueError('top_db must be non-negative')
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def logmel_plain(wav: torch.Tensor, cfg) -> torch.Tensor:
    """(B, samples) waveform -> (B, T, mel_bins) log-mel, T = samples //
    hop + 1 with center padding."""
    stft_mat, mel_mat = frontend_matrices(cfg, wav.device)
    spec = spectrogram(wav.to(torch.float32), stft_mat, cfg.hop_size,
                       center=cfg.center, pad_mode=cfg.pad_mode)
    mel = torch.matmul(spec, mel_mat)
    return power_to_db(mel, ref=cfg.ref, amin=cfg.amin, top_db=cfg.top_db)
