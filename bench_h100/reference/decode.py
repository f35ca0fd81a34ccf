"""Framewise probabilities -> events -> XML, for the reference side of
the correctness check (host numpy; nothing of the program).

The decoder follows the reference's dual-threshold activity detection
(``utils/vad.py``), quirks included: run starts after the first get +1,
every run end but the last gets +1; each pair extends to the edges of
its ``x >= low`` run, then pairs are merged across gaps of at most 1 and
of at most ``n_smooth``, and pairs of ``n_salt`` frames or fewer are
dropped.  The coverage divisor is the reference's ``avg_merge`` rule.
The XML is the reference's predict format (``pytorch/predict.py``).
"""

from __future__ import annotations

from xml.sax.saxutils import escape

import numpy as np

# the predict path's thresholds (``pytorch/predict.py``): high, low,
# n_smooth, n_salt, one set for every class
HIGH, LOW, N_SMOOTH, N_SALT = 0.5, 0.3, 10, 10


def coverage(total_frames: int, sample_duration: int = 5,
             hop_frames: int = 100) -> np.ndarray:
    """``avg_merge``'s divisor of each frame of a merged track."""
    interval = sample_duration * 100 - hop_frames
    div = np.ones(total_frames, np.float64)
    for i in range(hop_frames, total_frames - hop_frames, hop_frames):
        if i < interval:
            n = i // hop_frames + 1
        elif i >= total_frames - interval:
            n = (total_frames - i) // hop_frames + 1
        else:
            n = sample_duration
        div[i:i + hop_frames] = n
    return div


def _runs(mask: np.ndarray):
    idx = np.flatnonzero(mask)
    if not idx.size:
        return idx, idx
    gap = np.flatnonzero(np.diff(idx) > 1)
    return (idx[np.concatenate(([0], gap + 1))],
            idx[np.concatenate((gap, [idx.size - 1]))])


def _merge(bgn, fin, n):
    out = []
    for b, f in zip(bgn, fin):
        if out and b - prev_fin <= n:
            out[-1][1] = f
        else:
            out.append([b, f])
        prev_fin = f
    return [p[0] for p in out], [p[1] for p in out]


def track_pairs(x: np.ndarray, high: float = HIGH, low: float = LOW,
                n_smooth: int = N_SMOOTH, n_salt: int = N_SALT) -> list:
    """[bgn, fin] frame pairs of one probability track (thresholds in
    the track's own precision, as the program compares them)."""
    x = np.asarray(x)
    hi = x > np.asarray(high, x.dtype)
    lo = x >= np.asarray(low, x.dtype)
    starts, ends = _runs(hi)
    if not starts.size:
        return []
    bgn = [int(s) + (1 if i else 0) for i, s in enumerate(starts)]
    fin = [int(e) + 1 for e in ends]
    fin[-1] -= 1
    t = len(x)
    lo_starts, lo_ends = _runs(lo)
    run_of = np.cumsum(np.diff(lo.astype(np.int8), prepend=0) == 1) - 1
    new_b, new_f = [], []
    for b, f in zip(bgn, fin):
        # a boundary inside an x >= low run moves to that run's edge
        new_b.append(int(lo_starts[run_of[b]]) if b < t and lo[b]
                     else b + 1 if b < t else b)
        new_f.append(int(lo_ends[run_of[f]]) + 1 if f < t and lo[f] else f)
    bgn, fin = _merge(new_b, new_f, 1)
    bgn, fin = _merge(bgn, fin, n_smooth)
    return [[b, f] for b, f in zip(bgn, fin) if f - b > n_salt]


def events(probs: np.ndarray, labels, fps: int = 100) -> list:
    """(T, C) normalised probabilities -> [(label, onset, offset)] in the
    decoder's order: by class index, then by time."""
    out = []
    for c in range(probs.shape[1]):
        for b, f in track_pairs(probs[:, c]):
            out.append((labels[c], b / float(fps), f / float(fps)))
    return out


def xml(evs: list, name: str, fallback_span: tuple) -> str:
    """The reference's AudioDoc XML of (label, onset, offset) events."""
    parts = ['<AudioDoc name="{}">\n'.format(escape(name, {'"': '&quot;'})),
             '\t<SoundCaptionList>\n']
    if evs:
        for label, on, off in sorted(evs, key=lambda e: e[1]):
            parts.append('\t\t<SoundSegment stime="{}" dur="{}" event="{}">{}'
                         '</SoundSegment>\n'.format(
                             on, off - on, escape(label, {'"': '&quot;'}),
                             escape(label)))
    else:
        stime, etime = fallback_span
        parts.append('\t\t<SoundSegment stime="{}" dur="{}">Others'
                     '</SoundSegment>\n'.format(stime, etime - stime))
    parts.append('\t</SoundCaptionList>\n')
    parts.append('</AudioDoc>')
    return ''.join(parts)


def as_tuples(evs: list) -> list:
    """The program's event dicts as (label, onset, offset)."""
    return [(e['event_label'], float(e['onset']), float(e['offset']))
            for e in evs]
