"""The benchmark's traffic generator: synthetic SED clips, training pools
and batches, and live streams, all from the run's seed.

The clip synthesis is a copy of the program's ``bench_corpus.make_clips``
(six event classes with distinct spectral signatures, 1-3 freely
overlapping events a clip at levels 0.1-0.5, over low-passed, pink,
white or near-silent backgrounds), on which the repository's trained
checkpoint detects events; the pools and batches copy
``chip_smoke.train_data`` / ``train_batches``.  A traffic file
(``traffic/<name>.json``) gives the sizes; every seed gets the same
sizes and counts, in another order and with other content.
"""

from __future__ import annotations

import numpy as np

N_CLASSES = 6
BANDS = [(300, 500), (800, 1200), (2000, 2600), (3000, 4500), (5000, 6500),
         (6800, 7600)]
_RAMP_S = 0.02


def rng_seed(seed: int) -> int:
    """A seed of any size as numpy's legacy generator takes it."""
    return int(seed) % (2 ** 32)


def _envelope(n: int, sr: int) -> np.ndarray:
    ramp = max(1, min(int(_RAMP_S * sr), n // 2))
    env = np.ones(n, np.float32)
    env[:ramp] = np.linspace(0.0, 1.0, ramp, dtype=np.float32)
    env[-ramp:] = np.linspace(1.0, 0.0, ramp, dtype=np.float32)
    return env


def _bandnoise(rng, n: int, sr: int, lo: float, hi: float) -> np.ndarray:
    x = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / sr)
    spec[(f < lo) | (f > hi)] = 0.0
    y = np.fft.irfft(spec, n).astype(np.float32)
    rms = float(np.sqrt(np.mean(y * y))) or 1.0
    return y / rms


def _event(rng, k: int, n: int, sr: int) -> np.ndarray:
    lo, hi = BANDS[k]
    t = np.arange(n, dtype=np.float32) / sr
    phase = rng.uniform(0, 2 * np.pi)
    if k in (0, 1, 5):
        x = np.sin(2 * np.pi * rng.uniform(lo, hi) * t + phase)
    elif k == 2:
        f0 = rng.uniform(lo, hi)
        fm = rng.uniform(3.0, 8.0)
        depth = rng.uniform(0.5, 0.9)
        am = (1.0 + depth * np.sin(2 * np.pi * fm * t)) / (1.0 + depth)
        x = am * np.sin(2 * np.pi * f0 * t + phase)
    elif k == 3:
        span = (hi - lo) * rng.uniform(0.25, 0.5)
        f0 = rng.uniform(lo, hi - span)
        if rng.rand() < 0.5:
            f0, span = f0 + span, -span
        rate = span / t[-1] if n > 1 else 0.0
        x = np.sin(2 * np.pi * (f0 * t + 0.5 * rate * t * t) + phase)
    else:
        x = 0.7 * _bandnoise(rng, n, sr, lo, hi)
    return (x * _envelope(n, sr)).astype(np.float32)


def _background(rng, gen, shape, sr: int) -> np.ndarray:
    c, n = shape
    f = np.fft.rfftfreq(n, 1.0 / sr)
    spec = (gen.standard_normal((c, f.shape[0]), dtype=np.float32)
            + 1j * gen.standard_normal((c, f.shape[0]), dtype=np.float32))
    mask = np.ones((c, f.shape[0]), np.float32)
    for i in range(c):
        kind = rng.rand()
        if kind < 0.5:
            mask[i] = 1.0 / np.sqrt(1.0 + (f / rng.uniform(400.0, 4000.0)) ** 2)
        elif kind < 0.8:
            mask[i] = 1.0 / np.sqrt(1.0 + f / 30.0)
    out = np.fft.irfft(spec * mask, n, axis=1).astype(np.float32)
    rms = np.sqrt(np.mean(out * out, axis=1))
    level = np.exp(rng.uniform(np.log(0.005), np.log(0.08), c))
    level[rng.rand(c) < 0.05] = 1e-4
    out *= (level / np.maximum(rms, 1e-12))[:, None].astype(np.float32)
    return out


def make_clips(n: int, sr: int, seconds: int, seed: int, labels,
               events_per_clip=(1, 3)):
    """(n, sr * seconds) float32 clips in [-1, 1] and each clip's events
    [{'event_label', 'onset', 'offset'}], ``events_per_clip`` (the least
    and the most) drawn a clip."""
    rng = np.random.RandomState(rng_seed(seed))
    gen = np.random.default_rng(seed)
    length = sr * seconds
    lo, hi = events_per_clip
    clips = np.empty((n, length), np.float32)
    events = [[] for _ in range(n)]
    for c0 in range(0, n, 256):
        c1 = min(c0 + 256, n)
        clips[c0:c1] = _background(rng, gen, (c1 - c0, length), sr)
        for i in range(c0, c1):
            for _ in range(rng.randint(lo, hi + 1)):
                k = rng.randint(N_CLASSES)
                dur = rng.uniform(0.8, 2.5)
                s = rng.uniform(0.0, max(seconds - dur, 0.05))
                e = min(s + dur, float(seconds))
                i0, i1 = int(s * sr), min(int(e * sr), length)
                if i1 - i0 < sr // 50:
                    continue
                clips[i, i0:i1] += rng.uniform(0.1, 0.5) * _event(
                    rng, k, i1 - i0, sr)
                events[i].append({'event_label': labels[k],
                                  'onset': round(i0 / sr, 3),
                                  'offset': round(i1 / sr, 3)})
        np.clip(clips[c0:c1], -1.0, 1.0, out=clips[c0:c1])
    return clips, events


def to_int16(clips: np.ndarray) -> np.ndarray:
    return (np.clip(clips, -1, 1) * 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# serving: a pool of distinct clips, requests drawn from it
# ---------------------------------------------------------------------------

def request_rows(pool_size: int, request_clips: int, seed: int) -> list:
    """A seeded permutation of the pool cut into requests of
    ``request_clips`` rows (every pool clip in exactly one request)."""
    order = np.random.RandomState(rng_seed(seed) ^ 0x5EED).permutation(
        pool_size)
    return [order[i:i + request_clips]
            for i in range(0, pool_size, request_clips)]


# ---------------------------------------------------------------------------
# training: weak and strong pools, batches as the joint loop assembles them
# ---------------------------------------------------------------------------

def train_pool(n: int, sr: int, seconds: int, seed: int, labels,
               events_per_clip=(1, 3), fps: int = 100):
    """int16 clips, weak targets (class present) and strong targets at
    ``fps`` frames a second."""
    clips, evs = make_clips(n, sr, seconds, seed, labels, events_per_clip)
    weak = np.zeros((n, len(labels)), np.float32)
    strong = np.zeros((n, seconds * fps, len(labels)), np.float32)
    for i, clip_events in enumerate(evs):
        for e in clip_events:
            k = labels.index(e['event_label'])
            weak[i, k] = 1.0
            strong[i, int(e['onset'] * fps):int(e['offset'] * fps), k] = 1.0
    return to_int16(clips), weak, strong


class MixupLambdas:
    """The reference's host mixup stream: beta(alpha, alpha) a pair from
    ``np.random.RandomState(1234)``, as (lam, 1 - lam)."""

    def __init__(self, alpha: float = 1.0, seed: int = 1234):
        self.alpha = alpha
        self.rng = np.random.RandomState(seed)

    def get(self, batch: int) -> np.ndarray:
        out = []
        for _ in range(0, batch, 2):
            lam = self.rng.beta(self.alpha, self.alpha, 1)[0]
            out += [lam, 1.0 - lam]
        return np.array(out, np.float32)


def train_batches(weak_pool, strong_pool, seed: int, weak_bs: int,
                  strong_bs: int):
    """Endless (weak batch, [strong batch]) dicts of numpy rows drawn
    from the pools in a seeded order, with mixup lambdas (weak first)."""
    wpcm, wtarget, _ = weak_pool
    spcm, _, sstrong = strong_pool
    rng = np.random.RandomState(rng_seed(seed) ^ 0xBA7C)
    mix = MixupLambdas()
    while True:
        wi = rng.choice(len(wpcm), weak_bs, replace=len(wpcm) < weak_bs)
        si = rng.choice(len(spcm), strong_bs, replace=len(spcm) < strong_bs)
        weak = {'waveform': wpcm[wi], 'target': wtarget[wi],
                'mixup_lambda': mix.get(weak_bs)}
        strong = {'waveform': spcm[si], 'strong_target': sstrong[si],
                  'mixup_lambda': mix.get(strong_bs)}
        yield weak, [strong]


# ---------------------------------------------------------------------------
# live streams: each a concatenation of distinct pool clips
# ---------------------------------------------------------------------------

def stream_clips(pool_size: int, clips_per_stream: int, streams: int,
                 seed: int) -> list:
    """For each stream, ``clips_per_stream`` distinct pool indices."""
    rng = np.random.RandomState(rng_seed(seed) ^ 0x57AE)
    return [rng.choice(pool_size, clips_per_stream, replace=False)
            for _ in range(streams)]
