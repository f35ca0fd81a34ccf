"""Synthetic SED corpus of the bench checkpoint (a copy of
``tools/bench_corpus.py`` on the port's own ``LABELS``).

The corpus keeps a separable class structure (each class a distinct
spectral signature, so the small trained Cnn_9layers_Gru_FrameAtt of
``tools/bench_checkpoint.npz`` detects it) with content diversity:

* SIX event classes (LABELS[0..5]): two steady tone bands, an
  AM-modulated tone, a linear chirp, a band-limited noise burst, and a
  near-Nyquist high tone (the stress case for differential wires).
* 1-3 events per clip, FREELY OVERLAPPING across classes, with level
  diversity (0.1-0.5) and 20 ms attack/release ramps.
* Background diversity: low-passed noise (varied cutoff), pink-ish
  1/sqrt(f) noise, full-band white noise (the incompressible worst
  case), and near-silent clips — each at a log-uniform level.

Ground-truth strong labels are returned alongside the audio, so the
segment-based ER/F1 of a run can be scored against them.

Determinism: everything derives from the caller's seed; no global RNG.
The arrays equal ``tools/bench_corpus.py``'s for the same arguments.
"""

import numpy as np

from sed_tpu_torch.config import LABELS

N_CLASSES = 6

# per-class frequency bands (Hz); kept well-separated so the bench
# checkpoint learns a clean mapping.  Index = class index into LABELS.
BANDS = [
    (300, 500),      # 0: steady tone, low
    (800, 1200),     # 1: steady tone, mid
    (2000, 2600),    # 2: AM tone (3-8 Hz modulation)
    (3000, 4500),    # 3: linear chirp (sweeps ~1/3 of the band)
    (5000, 6500),    # 4: band-limited noise burst
    (6800, 7600),    # 5: steady tone, near-Nyquist
]

CLASS_LABELS = [LABELS[k] for k in range(N_CLASSES)]

_RAMP_S = 0.02


def _envelope(n: int, sr: int) -> np.ndarray:
    """Linear 20 ms attack/release ramp (click-free onsets)."""
    ramp = max(1, min(int(_RAMP_S * sr), n // 2))
    env = np.ones(n, np.float32)
    env[:ramp] = np.linspace(0.0, 1.0, ramp, dtype=np.float32)
    env[-ramp:] = np.linspace(1.0, 0.0, ramp, dtype=np.float32)
    return env


def _bandnoise(rng: np.random.RandomState, n: int, sr: int,
               lo: float, hi: float) -> np.ndarray:
    """Unit-RMS noise band-limited to [lo, hi] Hz (rfft masking)."""
    x = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / sr)
    spec[(f < lo) | (f > hi)] = 0.0
    y = np.fft.irfft(spec, n).astype(np.float32)
    rms = float(np.sqrt(np.mean(y * y))) or 1.0
    return y / rms


def synth_event(rng: np.random.RandomState, k: int, n: int,
                sr: int) -> np.ndarray:
    """One class-k event of n samples at unit peak-ish amplitude."""
    lo, hi = BANDS[k]
    t = np.arange(n, dtype=np.float32) / sr
    phase = rng.uniform(0, 2 * np.pi)
    if k in (0, 1, 5):                       # steady tones
        f0 = rng.uniform(lo, hi)
        x = np.sin(2 * np.pi * f0 * t + phase)
    elif k == 2:                             # AM tone
        f0 = rng.uniform(lo, hi)
        fm = rng.uniform(3.0, 8.0)
        depth = rng.uniform(0.5, 0.9)
        am = (1.0 + depth * np.sin(2 * np.pi * fm * t)) / (1.0 + depth)
        x = am * np.sin(2 * np.pi * f0 * t + phase)
    elif k == 3:                             # linear chirp
        span = (hi - lo) * rng.uniform(0.25, 0.5)
        f0 = rng.uniform(lo, hi - span)
        if rng.rand() < 0.5:
            f0, span = f0 + span, -span
        rate = span / t[-1] if n > 1 else 0.0
        x = np.sin(2 * np.pi * (f0 * t + 0.5 * rate * t * t) + phase)
    else:                                    # band-limited noise burst
        x = 0.7 * _bandnoise(rng, n, sr, lo, hi)
    return (x * _envelope(n, sr)).astype(np.float32)


def _background(rng: np.random.RandomState, gen: np.random.Generator,
                shape, sr: int) -> np.ndarray:
    """(chunk, n) backgrounds: per-clip colored/white/near-silent noise
    at log-uniform levels.  Vectorized across the chunk (rfft masking),
    with the coloring drawn per clip."""
    c, n = shape
    f = np.fft.rfftfreq(n, 1.0 / sr)
    # draw the gaussian spectrum DIRECTLY (equivalent in law to
    # rfft(white); skips the forward transform — generation time delays
    # the bench's first timed draw)
    spec = (gen.standard_normal((c, f.shape[0]), dtype=np.float32)
            + 1j * gen.standard_normal((c, f.shape[0]),
                                       dtype=np.float32))
    mask = np.ones((c, f.shape[0]), np.float32)
    for i in range(c):                     # masks per clip, ONE irfft
        kind = rng.rand()
        if kind < 0.5:                     # low-passed, varied cutoff
            fc = rng.uniform(400.0, 4000.0)
            mask[i] = 1.0 / np.sqrt(1.0 + (f / fc) ** 2)
        elif kind < 0.8:                   # pink-ish 1/sqrt(f)
            mask[i] = 1.0 / np.sqrt(1.0 + f / 30.0)
        # else: full-band white (worst case for compression)
    out = np.fft.irfft(spec * mask, n, axis=1).astype(np.float32)
    rms = np.sqrt(np.mean(out * out, axis=1))
    level = np.exp(rng.uniform(np.log(0.005), np.log(0.08), c))
    level[rng.rand(c) < 0.05] = 1e-4       # near-silent clips
    out *= (level / np.maximum(rms, 1e-12))[:, None].astype(np.float32)
    return out


def make_clips(n: int, sr: int, seconds: int = 5, seed: int = 0,
               return_events: bool = False,
               min_events: int = 1, max_events: int = 3,
               min_dur: float = 0.8, max_dur: float = 2.5):
    """n clips of `seconds` s with 1-3 freely-overlapping class events
    over diverse backgrounds.  Returns (n, sr*seconds) float32, plus —
    when ``return_events`` — a per-clip list of ground-truth
    ``{'event_label', 'onset', 'offset'}`` dicts.

    Built in ~256-clip chunks: one giant allocation measured
    pathologically slow on the JAX package's bench host (its
    BENCHMARKS.md host-memory note),
    while chunk-sized working sets stay cache-friendly.
    """
    rng = np.random.RandomState(seed)
    gen = np.random.default_rng(seed)
    length = sr * seconds
    clips = np.empty((n, length), np.float32)
    events = [[] for _ in range(n)]
    chunk = 256
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        clips[c0:c1] = _background(rng, gen, (c1 - c0, length), sr)
        for i in range(c0, c1):
            for _ in range(rng.randint(min_events, max_events + 1)):
                k = rng.randint(N_CLASSES)
                dur = rng.uniform(min_dur, max_dur)
                s = rng.uniform(0.0, max(seconds - dur, 0.05))
                e = min(s + dur, float(seconds))
                i0, i1 = int(s * sr), min(int(e * sr), length)
                if i1 - i0 < sr // 50:
                    continue
                level = rng.uniform(0.1, 0.5)
                clips[i, i0:i1] += level * synth_event(
                    rng, k, i1 - i0, sr)
                events[i].append({'event_label': LABELS[k],
                                  'onset': round(i0 / sr, 3),
                                  'offset': round(i1 / sr, 3)})
        np.clip(clips[c0:c1], -1.0, 1.0, out=clips[c0:c1])
    if return_events:
        return clips, events
    return clips
