"""Auxiliary DSP transforms on tensors: DFT family, ISTFT, magphase,
enframe, scalar (counterpart of ``sed_tpu/dsp/transforms.py``, in its
matrix formulation: every transform is a matmul with a numpy-built
matrix, on the input's device, in the input's dtype).

Completes the reference DSP API surface (``pytorch/stft.py``):

* ``dft/idft/rdft/irdft`` — matmul DFTs with None|'ortho' norm
  (``stft.py:34-154``; including the reference's idft quirk of scaling
  only the real part under norm=None, ``stft.py:92-96`` — fixed here to
  scale both, see ``idft``'s docstring);
* ``magphase`` (``stft.py:250-266``);
* ``istft`` — inverse STFT via windowed overlap-add with window-sum
  normalization, librosa semantics (``stft.py:269-633``);
* ``enframe`` (``stft.py:868-907``), ``scalar_normalize``
  (``stft.py:910-922``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sed_tpu_torch.dsp import filters
from sed_tpu_torch.dsp.frontend import frame_signal


@functools.lru_cache(maxsize=8)
def _dft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    angle = -2.0 * np.pi * np.outer(k, k) / n
    return np.cos(angle), np.sin(angle)


def _like(a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """numpy ``a`` as a tensor of ``x``'s dtype on ``x``'s device."""
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def dft(x_real: torch.Tensor, x_imag: torch.Tensor,
        norm: Optional[str] = None):
    """Complex DFT along the last axis via matmul."""
    n = x_real.shape[-1]
    wr, wi = _dft_mats(n)
    wr, wi = _like(wr, x_real), _like(wi, x_real)
    z_real = x_real @ wr - x_imag @ wi
    z_imag = x_imag @ wr + x_real @ wi
    if norm == 'ortho':
        z_real, z_imag = z_real / np.sqrt(n), z_imag / np.sqrt(n)
    return z_real, z_imag


def idft(x_real: torch.Tensor, x_imag: torch.Tensor,
         norm: Optional[str] = None):
    """Inverse DFT.  NB: the reference divides only the real part by n
    under norm=None (``stft.py:92-96``, a bug); both parts are scaled
    here so that idft(dft(x)) == x."""
    n = x_real.shape[-1]
    wr, wi = _dft_mats(n)
    wr, wi = _like(wr, x_real), -_like(wi, x_real)
    z_real = x_real @ wr - x_imag @ wi
    z_imag = x_imag @ wr + x_real @ wi
    if norm is None:
        z_real, z_imag = z_real / n, z_imag / n
    elif norm == 'ortho':
        z_real, z_imag = z_real / np.sqrt(n), z_imag / np.sqrt(n)
    return z_real, z_imag


def rdft(x_real: torch.Tensor, norm: Optional[str] = None):
    """Real-input DFT: returns the first n//2+1 bins."""
    n = x_real.shape[-1]
    n_rfft = n // 2 + 1
    wr, wi = _dft_mats(n)
    z_real = x_real @ _like(wr[:, :n_rfft], x_real)
    z_imag = x_real @ _like(wi[:, :n_rfft], x_real)
    if norm == 'ortho':
        z_real, z_imag = z_real / np.sqrt(n), z_imag / np.sqrt(n)
    return z_real, z_imag


def irdft(x_real: torch.Tensor, x_imag: torch.Tensor,
          norm: Optional[str] = None):
    """Inverse of rdft: reconstructs the full spectrum by conjugate
    symmetry then inverse-transforms (``stft.py:120-154``)."""
    mirror = list(range(x_real.shape[-1] - 2, 0, -1))   # bins n/2-1 .. 1
    full_real = torch.cat([x_real, x_real[..., mirror]], dim=-1)
    full_imag = torch.cat([x_imag, -x_imag[..., mirror]], dim=-1)
    z_real, _ = idft(full_real, full_imag, norm)
    return z_real


def magphase(real: torch.Tensor, imag: torch.Tensor):
    """(mag, cos, sin) from re/im (``stft.py:250-266``)."""
    mag = torch.sqrt(real ** 2 + imag ** 2)
    denom = torch.clamp(mag, min=1e-10)
    return mag, real / denom, imag / denom


@functools.lru_cache(maxsize=8)
def _istft_operands(n_fft: int, hop_length: int, t: int, dtype, device):
    """The inverse rFFT matrices, the window, the overlap-add indices and
    the clamped window sum of ``t`` frames, built once per shape on
    ``device`` (building them is most of a call's time)."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_fft)
    b = np.arange(n_bins)
    angle = 2.0 * np.pi * np.outer(b, k) / n_fft
    # conjugate-symmetric expansion weights: bins 1..n/2-1 count twice
    scale = np.ones(n_bins)
    scale[1:-1] = 2.0
    s_real = (np.cos(angle) * scale[:, None]) / n_fft
    s_imag = (-np.sin(angle) * scale[:, None]) / n_fft
    win = filters.pad_center(filters.periodic_hann(n_fft), n_fft)
    win = torch.as_tensor(win, dtype=dtype, device=device)
    out_len = n_fft + hop_length * (t - 1)
    idx = (np.arange(t)[:, None] * hop_length
           + np.arange(n_fft)[None, :]).reshape(-1)
    win_sq = np.zeros(out_len)
    w2 = win.cpu().numpy() ** 2
    for i in range(t):
        win_sq[i * hop_length:i * hop_length + n_fft] += w2
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (s_real, s_imag)) + (
        win, torch.as_tensor(idx, device=device),
        torch.as_tensor(np.maximum(win_sq, 1e-11), dtype=dtype,
                        device=device))


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int,
          hop_length: int, length: Optional[int] = None,
          window: str = 'hann', center: bool = True) -> torch.Tensor:
    """Inverse STFT via windowed overlap-add (librosa.istft semantics).

    Args:
      real, imag: (..., T, n_fft // 2 + 1) one-sided STFT.
    Returns:
      (..., samples) reconstructed signal.
    """
    if window != 'hann':
        raise ValueError(f'unsupported window: {window}')
    assert real.shape[-1] == n_fft // 2 + 1
    t = real.shape[-2]
    s_real, s_imag, win, idx, win_sq = _istft_operands(
        n_fft, hop_length, t, real.dtype, real.device)

    # inverse rFFT per frame as a matmul: frames = [re|im] @ S
    frames = (real @ s_real + imag @ s_imag) * win
    out_len = win_sq.shape[0]
    batch_shape = frames.shape[:-2]
    flat = frames.reshape((-1, t * n_fft))
    sig = flat.new_zeros((flat.shape[0], out_len)).index_add_(1, idx, flat)
    sig = sig / win_sq

    if center:
        sig = sig[:, n_fft // 2:out_len - n_fft // 2]
    if length is not None:
        sig = sig[:, :length]
        if sig.shape[-1] < length:
            sig = F.pad(sig, (0, length - sig.shape[-1]))
    return sig.reshape(batch_shape + sig.shape[-1:])


def enframe(x: torch.Tensor, frame_length: int = 2048,
            hop_length: int = 512) -> torch.Tensor:
    """librosa.util.frame equivalent: (B, samples) ->
    (B, frame_length, frames) (``stft.py:868-907``)."""
    frames = frame_signal(x, frame_length, hop_length, center=False)
    return frames.transpose(-1, -2)


def scalar_normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std (``stft.py:910-922``)."""
    return (x - _like(np.asarray(mean), x)) / _like(np.asarray(std), x)
