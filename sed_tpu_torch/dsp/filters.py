"""Filter design for the DSP frontend (pure numpy, float64).

The reference builds its STFT from dense DFT matrices loaded into conv1d
weights (``pytorch/stft.py:202-217``) and takes its mel filterbank from
``librosa.filters.mel`` (``pytorch/stft.py:688-692``).  librosa is not a
dependency here: the Slaney-style mel filterbank and periodic Hann window
are derived from first principles below and verified against independent
FFT-based gold in tests.

A copy of ``sed_tpu/dsp/filters.py``: the port keeps its own host modules
and imports nothing of the JAX package.
"""

from __future__ import annotations

import functools as _functools
import numpy as np

# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------


def periodic_hann(n: int) -> np.ndarray:
    """Periodic ("fftbins=True") Hann window of length ``n``.

    Equals ``scipy.signal.get_window('hann', n, fftbins=True)``, which is
    what ``librosa.filters.get_window`` returns in the reference STFT
    (``pytorch/stft.py:193``).
    """
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window out to ``size`` samples (librosa.util.pad_center)."""
    n = len(window)
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad:lpad + n] = window
    return out


# ---------------------------------------------------------------------------
# DFT / STFT matrices
# ---------------------------------------------------------------------------


def stft_matrices(n_fft: int, win_length: int | None = None,
                  window: str = 'hann') -> np.ndarray:
    """Windowed real-DFT analysis matrix.

    Returns ``W`` of shape ``(n_fft, 2 * n_bins)`` with ``n_bins =
    n_fft // 2 + 1``; the first ``n_bins`` columns produce the real part
    and the rest the imaginary part:  ``frames @ W -> [re | im]``.

    One matrix keeps the whole STFT a single MXU matmul.  Matches the
    conv-weight construction of the reference (``pytorch/stft.py:210-217``):
    ``W[n, k] = window[n] * cos(-2*pi*k*n/N)`` (real) and ``sin`` (imag).
    """
    if win_length is None:
        win_length = n_fft
    if window != 'hann':
        raise ValueError(f'unsupported window: {window}')
    w = pad_center(periodic_hann(win_length), n_fft)

    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)
    angle = -2.0 * np.pi * np.outer(n, k) / n_fft      # (n_fft, n_bins)
    real = np.cos(angle) * w[:, None]
    imag = np.sin(angle) * w[:, None]
    return np.concatenate([real, imag], axis=1)        # (n_fft, 2*n_bins)


# ---------------------------------------------------------------------------
# Mel filterbank (Slaney scale, matching librosa.filters.mel defaults)
# ---------------------------------------------------------------------------


def hz_to_mel(freq, htk: bool = False):
    """Convert Hz to mels (Slaney formulation by default)."""
    freq = np.asanyarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = freq >= min_log_hz
        mels[log_t] = min_log_mel + np.log(freq[log_t] / min_log_hz) / logstep
    elif freq >= min_log_hz:
        mels = min_log_mel + np.log(freq / min_log_hz) / logstep
    return mels


def mel_to_hz(mels, htk: bool = False):
    """Convert mels to Hz (Slaney formulation by default)."""
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float,
                    htk: bool = False) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the mel scale."""
    min_mel = hz_to_mel(fmin, htk=htk)
    max_mel = hz_to_mel(fmax, htk=htk)
    mels = np.linspace(min_mel, max_mel, n_mels)
    return mel_to_hz(mels, htk=htk)


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 64,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False, norm: str | None = 'slaney') -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_fft // 2 + 1, n_mels)``.

    Semantics match ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax).T``
    used by the reference (``pytorch/stft.py:688-692``): Slaney mel scale,
    triangular ramps over the FFT bin frequencies, Slaney area
    normalization.  Returned transposed relative to librosa so that
    ``spectrogram @ melW`` is the projection.
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)                  # (1 + n_fft/2,)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk)   # (n_mels + 2,)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]             # (n_mels+2, bins)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))    # (n_mels, bins)

    if norm == 'slaney':
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f'unsupported norm: {norm}')

    return weights.T.astype(np.float64)                    # (bins, n_mels)


@_functools.lru_cache(maxsize=8)
def frontend_arrays(cfg) -> tuple:
    """Precomputed (stft_mat, mel_mat) float32 numpy constants for an
    AudioConfig — the single builder shared by the XLA frontend
    (models/base.py) and the fused Pallas kernel (ops/logmel_kernel.py)
    so the two paths can never diverge."""
    stft_mat = stft_matrices(cfg.window_size, cfg.window_size,
                             cfg.window).astype(np.float32)
    mel_mat = mel_filterbank(cfg.sample_rate, cfg.window_size,
                             cfg.mel_bins, cfg.fmin,
                             cfg.fmax).astype(np.float32)
    return stft_mat, mel_mat
