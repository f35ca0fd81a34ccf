"""Pseudo-constant-Q filterbank frontend (counterpart of
``sed_tpu/dsp/cqt.py``; the filterbank's numpy verbatim).

The reference ships a ``CQTFilterBank`` that is dead code — its
``librosa.filters.constant_q`` call signature is wrong and its log scaling
clamps incorrectly (``pytorch/stft.py:804-865``; only a commented-out use
at ``models.py:593-596``).  This is the working equivalent: a pseudo-CQT
in the same shape as the reference intended — a power spectrogram
projected through a constant-Q filterbank matrix (log-spaced center
frequencies, constant Q = f/bandwidth, triangular responses over the FFT
bins) followed by ``power_to_db``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sed_tpu_torch.config import AudioConfig
from sed_tpu_torch.dsp import filters
from sed_tpu_torch.dsp import frontend as fe


def cqt_frequencies(n_bins: int, fmin: float,
                    bins_per_octave: int = 12) -> np.ndarray:
    """Log-spaced center frequencies: fmin * 2^(k / bins_per_octave)."""
    return fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)


def cqt_filterbank(sr: int, n_fft: int, n_bins: int = 80,
                   fmin: float = 32.703195,
                   bins_per_octave: int = 12) -> np.ndarray:
    """Constant-Q filterbank matrix, shape (n_fft // 2 + 1, n_bins).

    Each filter is a triangular response centred at the log-spaced
    frequency with half-width f_k * (2^(1/bins_per_octave) - 1) (constant
    Q), area-normalized like the Slaney mel filters.
    """
    freqs = cqt_frequencies(n_bins, fmin, bins_per_octave)
    fftfreqs = filters.fft_frequencies(sr, n_fft)
    alpha = 2.0 ** (1.0 / bins_per_octave) - 1.0
    weights = np.zeros((n_bins, len(fftfreqs)))
    for k, f in enumerate(freqs):
        bw = max(f * alpha, fftfreqs[1])          # >= one FFT bin
        tri = 1.0 - np.abs(fftfreqs - f) / bw
        weights[k] = np.maximum(0.0, tri) * (2.0 / (2 * bw))
    return weights.T


class CQTFrontend(nn.Module):
    """Waveform -> log pseudo-CQT, mirroring the log-mel frontend:
    ``(B, samples) -> (B, T, n_bins)`` in float32 on ``device`` (the card
    unless the caller asks for the CPU; a CUDA device that is absent, or
    TF32 on, raises).  The STFT and CQ matrices are buffers."""

    def __init__(self, cfg: AudioConfig, n_bins: int = 80,
                 bins_per_octave: int = 12, fmin: float | None = None,
                 device='cuda'):
        from sed_tpu_torch.serve.engine import check_device
        super().__init__()
        device = check_device(device)
        self.cfg = cfg
        fmin = float(cfg.fmin) if fmin is None else fmin
        self.register_buffer('stft_mat', torch.tensor(
            filters.stft_matrices(cfg.window_size), dtype=torch.float32,
            device=device))
        self.register_buffer('cq_mat', torch.tensor(
            cqt_filterbank(cfg.sample_rate, cfg.window_size, n_bins, fmin,
                           bins_per_octave), dtype=torch.float32,
            device=device))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        spec = fe.spectrogram(wav.to(self.stft_mat.dtype), self.stft_mat,
                              self.cfg.hop_size, center=self.cfg.center,
                              pad_mode=self.cfg.pad_mode)
        cq = torch.matmul(spec, self.cq_mat)
        return fe.power_to_db(cq, ref=self.cfg.ref, amin=self.cfg.amin,
                              top_db=self.cfg.top_db)
