"""Gammatone auditory filterbank frontend (a copy of
``sed_tpu/dsp/gammatone.py``: its numpy half verbatim, its batched
gammatonegram on tensors).

Re-derivation of the ERB-scale gammatone machinery the reference vendors
in ``utils/gammatone/`` (Patterson-Holdsworth filterbank per Slaney's
Apple TR #35; FFT approximation per Ellis' fft2gammatonemx):

* ERB frequency scale with ear_q = 9.26449, min_bw = 24.7
  (``gammatone/filters.py:21-87``);
* 4x-cascaded second-order IIR design (``gammatone/filters.py:90-193``);
* FFT-bin -> gammatone-band weight matrix (``gammatone/fftweight.py:63-123``);
* FFT-approximated gammatonegram (``gammatone/fftweight.py:126-168``),
  which the reference precomputes at pack time
  (``utils/features.py:361-363``) with ``librosa.power_to_db`` defaults
  (top_db = 80);
* true time-domain gammatonegram (``gammatone/gtgram.py:23-86``).

Design (ERB math) runs in float64 numpy; ``fft_gtgram_batch`` is two
float32 matmuls on the input's device (frames x windowed-DFT matrix ->
|.| -> band weights), which must not run in TF32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.signal import lfilter

from sed_tpu_torch.config import AudioConfig

EAR_Q = 9.26449  # Glasberg & Moore
MIN_BW = 24.7


# ---------------------------------------------------------------------------
# ERB scale
# ---------------------------------------------------------------------------


def erb_point(low_freq: float, high_freq: float, fraction) -> np.ndarray:
    """Frequency at ``fraction`` of the ERB scale between the limits
    (fraction 1 -> low_freq, 0 -> high_freq)."""
    c = EAR_Q * MIN_BW
    fraction = np.asarray(fraction, np.float64)
    return -c + np.exp(
        fraction * (np.log(low_freq + c) - np.log(high_freq + c))
    ) * (high_freq + c)


def erb_space(low_freq: float, high_freq: float, num: int) -> np.ndarray:
    """``num`` frequencies uniformly spaced on the ERB scale, descending
    from just below high_freq to low_freq."""
    return erb_point(low_freq, high_freq, np.arange(1, num + 1) / num)


def centre_freqs(fs: float, num_freqs: int, cutoff: float) -> np.ndarray:
    return erb_space(cutoff, fs / 2.0, num_freqs)


# ---------------------------------------------------------------------------
# Filter design
# ---------------------------------------------------------------------------


def make_erb_filters(fs: float, cfs: np.ndarray,
                     width: float = 1.0) -> np.ndarray:
    """Coefficient array (channels, 10): columns
    [A0, A11, A12, A13, A14, A2, B0, B1, B2, gain] for the four cascaded
    second-order gammatone sections sharing one pole pair."""
    cfs = np.asarray(cfs, np.float64)
    t = 1.0 / fs
    erb = width * (cfs / EAR_Q + MIN_BW)
    b = 1.019 * 2.0 * np.pi * erb

    arg = 2.0 * np.pi * cfs * t
    vec = np.exp(2j * arg)

    b1 = -2.0 * np.cos(arg) * np.exp(-b * t)
    b2 = np.exp(-2.0 * b * t)

    rt_pos = np.sqrt(3.0 + 2.0 ** 1.5)
    rt_neg = np.sqrt(3.0 - 2.0 ** 1.5)
    common = -t * np.exp(-b * t)
    k = np.stack([np.cos(arg) + rt_pos * np.sin(arg),
                  np.cos(arg) - rt_pos * np.sin(arg),
                  np.cos(arg) + rt_neg * np.sin(arg),
                  np.cos(arg) - rt_neg * np.sin(arg)])
    a1x = common * k  # (4, channels): A11, A12, A13, A14

    gain_arg = np.exp(1j * arg - b * t)
    gain = np.abs(
        (vec - gain_arg * k[0]) * (vec - gain_arg * k[1])
        * (vec - gain_arg * k[2]) * (vec - gain_arg * k[3])
        * (t * np.exp(b * t)
           / (-np.exp(-b * t) + 1 + vec * (1 - np.exp(b * t)))) ** 4)

    ones = np.ones_like(cfs)
    return np.column_stack([t * ones, a1x[0], a1x[1], a1x[2], a1x[3],
                            0.0 * ones, ones, b1, b2, gain])


def erb_filterbank(wave: np.ndarray, coefs: np.ndarray) -> np.ndarray:
    """Time-domain IIR filtering, one output row per channel
    (``gammatone/filters.py:196-240``)."""
    out = np.zeros((coefs.shape[0], wave.shape[0]))
    bs = coefs[:, 6:9]
    for i in range(coefs.shape[0]):
        y = wave
        for a_col in (1, 2, 3, 4):
            y = lfilter([coefs[i, 0], coefs[i, a_col], coefs[i, 5]],
                        bs[i], y)
        out[i] = y / coefs[i, 9]
    return out


# ---------------------------------------------------------------------------
# True (time-domain) gammatonegram
# ---------------------------------------------------------------------------


def _round_half_away(x) -> np.ndarray:
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def gtgram_strides(fs: float, window_time: float, hop_time: float,
                   total_cols: int):
    nwin = int(_round_half_away(window_time * fs))
    hop = int(_round_half_away(hop_time * fs))
    cols = 1 + int(np.floor((total_cols - nwin) / hop))
    return nwin, hop, cols


def gtgram(wave: np.ndarray, fs: float, window_time: float, hop_time: float,
           channels: int, f_min: float) -> np.ndarray:
    """Filter -> square -> windowed RMS (``gammatone/gtgram.py:52-86``)."""
    cfs = centre_freqs(fs, channels, f_min)
    coefs = np.flipud(make_erb_filters(fs, cfs))
    xe = erb_filterbank(wave, coefs) ** 2
    nwin, hop, ncols = gtgram_strides(fs, window_time, hop_time, xe.shape[1])
    y = np.empty((channels, ncols))
    for c in range(ncols):
        y[:, c] = np.sqrt(xe[:, c * hop:c * hop + nwin].mean(axis=1))
    return y


# ---------------------------------------------------------------------------
# FFT approximation
# ---------------------------------------------------------------------------


def specgram_window(nfft: int, nwin: int) -> np.ndarray:
    """Half-Hann mirrored around the array midpoint, as in Ellis'
    myspecgram (``gammatone/fftweight.py:16-30``)."""
    halflen = nwin // 2
    halff = nfft // 2
    acthalflen = int(np.floor(min(halff, halflen)))
    ramp = 0.5 * (1 + np.cos(np.pi * np.arange(halflen + 1) / halflen))
    win = np.zeros(nfft)
    win[halff:halff + acthalflen] = ramp[:acthalflen]
    win[halff:halff - acthalflen:-1] = ramp[:acthalflen]
    return win


def fft_weights(nfft: int, fs: float, nfilts: int, width: float,
                fmin: float, fmax: float, maxlen: int):
    """FFT-bin -> gammatone-band weights (Ellis fft2gammatonemx)."""
    ucirc = np.exp(1j * 2 * np.pi * np.arange(nfft // 2 + 1) / nfft)[None]
    cfs = erb_space(fmin, fmax, nfilts)[::-1]
    coefs = make_erb_filters(fs, cfs, width)
    a1x = coefs[:, 1:5][..., None]           # (nfilts, 4, 1)
    b2 = coefs[:, 8]
    gain = coefs[:, 9]

    r = np.sqrt(b2)
    theta = 2 * np.pi * cfs / fs
    pole = (r * np.exp(1j * theta))[:, None]

    num = np.prod(np.abs(ucirc[None] + a1x * fs), axis=1)
    den = np.abs(fs * (pole - ucirc) * (pole.conj() - ucirc)) ** 4
    weights = np.zeros((nfilts, nfft))
    weights[:, :ucirc.shape[1]] = num / den / gain[:, None]
    return weights[:, :int(maxlen)], gain


def _fft_gtgram_geometry(fs: float, window_time: float, hop_time: float):
    nfft = int(2 ** np.ceil(np.log2(2 * window_time * fs)))
    nwin, nhop, _ = gtgram_strides(fs, window_time, hop_time, 0)
    return nfft, nwin, nhop


@functools.lru_cache(maxsize=16)
def _fft_gtgram_matrices(fs: int, window_time: float, hop_time: float,
                         channels: int, f_min: float):
    """(analysis matrix (nfft, 2*bins), weights (bins, channels), nfft,
    nhop) for the MXU formulation of fft_gtgram."""
    nfft, nwin, nhop = _fft_gtgram_geometry(fs, window_time, hop_time)
    win = specgram_window(nfft, nwin)
    n_bins = nfft // 2 + 1
    n = np.arange(nfft, dtype=np.float64)
    kk = np.arange(n_bins, dtype=np.float64)
    angle = -2.0 * np.pi * np.outer(n, kk) / nfft
    analysis = np.concatenate([np.cos(angle) * win[:, None],
                               np.sin(angle) * win[:, None]], axis=1)
    weights, _ = fft_weights(nfft, fs, channels, 1, f_min, fs / 2,
                             nfft / 2 + 1)
    return (analysis.astype(np.float32),
            weights.T.astype(np.float32) / nfft, nfft, nhop)


def fft_gtgram(wave: np.ndarray, fs: int, window_time: float,
               hop_time: float, channels: int, f_min: float) -> np.ndarray:
    """FFT-approximated gammatonegram, shape (channels, frames)
    (``gammatone/fftweight.py:126-168``); numpy host path."""
    analysis, weights, nfft, nhop = _fft_gtgram_matrices(
        int(fs), window_time, hop_time, channels, f_min)
    s = wave.shape[0]
    n_frames = max(0, -(-(s - nfft) // nhop))  # frames at b < s - nfft
    # the reference specgram pre-allocates 1 + floor((s-n)/h) columns but
    # its loop fills only ceil((s-n)/h): when (s-n) divides h exactly the
    # final column stays all-zero (``gammatone/fftweight.py:51-55``)
    n_cols = 1 + (s - nfft) // nhop if s >= nfft else n_frames
    frames = np.stack([wave[b * nhop:b * nhop + nfft]
                       for b in range(n_frames)])
    re_im = frames @ analysis.astype(np.float64)
    n_bins = nfft // 2 + 1
    mag = np.hypot(re_im[:, :n_bins], re_im[:, n_bins:])
    out = (mag @ weights.astype(np.float64)).T
    if n_cols > n_frames:
        out = np.concatenate(
            [out, np.zeros((out.shape[0], n_cols - n_frames))], axis=1)
    return out


@functools.lru_cache(maxsize=16)
def _device_matrices(fs: int, window_time: float, hop_time: float,
                     channels: int, f_min: float, device: torch.device):
    """``_fft_gtgram_matrices``' two float32 operands on ``device``."""
    analysis, weights, _, _ = _fft_gtgram_matrices(
        fs, window_time, hop_time, channels, f_min)
    return (torch.from_numpy(analysis).to(device),
            torch.from_numpy(weights).to(device))


def fft_gtgram_batch(waves: torch.Tensor, fs: int, window_time: float,
                     hop_time: float, channels: int,
                     f_min: float) -> torch.Tensor:
    """Batched fft_gtgram on tensors: (B, samples) -> (B, channels,
    frames), float32 on ``waves``' device.  Framing + two matmuls
    (windowed DFT, then band weights); a CUDA input while TF32 is on
    raises."""
    from sed_tpu_torch.dsp.frontend import frame_signal
    from sed_tpu_torch.serve.engine import check_device
    _, _, nfft, nhop = _fft_gtgram_matrices(
        int(fs), window_time, hop_time, channels, f_min)
    analysis, weights = _device_matrices(
        int(fs), window_time, hop_time, channels, f_min,
        check_device(waves.device))
    s = waves.shape[-1]
    n_frames = max(0, -(-(s - nfft) // nhop))
    # trailing all-zero column when (s-nfft) % nhop == 0, like the
    # reference specgram (see fft_gtgram above)
    n_cols = 1 + (s - nfft) // nhop if s >= nfft else n_frames
    frames = frame_signal(waves.to(torch.float32), nfft, nhop,
                          center=False)[..., :n_frames, :]
    re_im = torch.matmul(frames, analysis)
    n_bins = nfft // 2 + 1
    mag = torch.sqrt(re_im[..., :n_bins] ** 2 + re_im[..., n_bins:] ** 2)
    out = torch.matmul(mag, weights)
    if n_cols > n_frames:
        out = torch.nn.functional.pad(out, (0, 0, 0, n_cols - n_frames))
    return out.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Pack-time helpers (``utils/features.py:361-363``)
# ---------------------------------------------------------------------------


def power_to_db_np(x: np.ndarray, ref: float = 1.0, amin: float = 1e-10,
                   top_db: float = 80.0) -> np.ndarray:
    """librosa.power_to_db with its defaults (note: top_db=80 here,
    unlike the model frontend's top_db=None)."""
    log_spec = 10.0 * np.log10(np.maximum(x, amin))
    log_spec -= 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def gtgram_frames(cfg: AudioConfig, samples: int) -> int:
    """Frame count of the packed gammatonegram (994 for 10 s clips)."""
    nfft, _, nhop = _fft_gtgram_geometry(
        cfg.sample_rate, cfg.window_size / cfg.sample_rate,
        cfg.hop_size / cfg.sample_rate)
    return max(0, -(-(samples - nfft) // nhop))


def fft_gtgram_db(audio: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Pack-time gammatone feature: fft_gtgram at the quality's
    window/hop + power_to_db(top_db=80), shape (mel_bins, frames)."""
    g = fft_gtgram(audio, cfg.sample_rate,
                   cfg.window_size / cfg.sample_rate,
                   cfg.hop_size / cfg.sample_rate,
                   cfg.mel_bins, cfg.fmin)
    return power_to_db_np(g)
