"""Dual-threshold activity detection (event decoding), host-side numpy.

Behavioral parity with the reference decoder (``utils/vad.py:11-199``),
including its index quirks, because the published ER/F1 numbers depend on
them:

* run starts after the first run get +1; every run end gets +1 except the
  last (``utils/vad.py:108-130``);
* the low-threshold pass extends each boundary to the edge of the
  surrounding ``x >= low`` run and then re-smooths with gap 1
  (``utils/vad.py:133-155``);
* ``smooth`` merges pairs whose gap to the *original* previous pair is
  <= n_smooth (``utils/vad.py:158-183``);
* events with ``fin - bgn <= n_salt`` are dropped (``utils/vad.py:186-199``).

The implementation here is run-length based (numpy) rather than per-frame
Python loops, so a whole track decodes in a handful of vector ops.

A copy of ``sed_tpu/post/vad.py``: the port keeps its own host modules
and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def _runs_from_mask(mask: np.ndarray):
    """Consecutive True runs of a 1-D bool mask -> (starts, ends) inclusive."""
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        return idx, idx
    gap = np.flatnonzero(np.diff(idx) > 1)
    starts = idx[np.concatenate(([0], gap + 1))]
    ends = idx[np.concatenate((gap, [idx.size - 1]))]
    return starts, ends


def _high_pairs_from_mask(high: np.ndarray):
    """Pairs from the high-threshold mask with the reference's +1
    offsets."""
    starts, ends = _runs_from_mask(high)
    if starts.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    bgn = starts.copy()
    bgn[1:] += 1          # non-first run starts shift right by one
    fin = ends + 1
    fin[-1] -= 1          # last run end is inclusive, others exclusive
    return bgn, fin


def _extend_low_mask(low: np.ndarray, bgn: np.ndarray, fin: np.ndarray):
    """Extend each pair to the boundary of the surrounding low-mask run."""
    T = len(low)
    starts, ends = _runs_from_mask(low)

    # run_start_at[t] = start of the low-run containing t (only valid if low[t])
    run_start_at = np.full(T, -1, np.int64)
    run_end_at = np.full(T, T, np.int64)
    for s, e in zip(starts, ends):
        run_start_at[s:e + 1] = s
        run_end_at[s:e + 1] = e

    new_bgn = np.empty_like(bgn)
    new_fin = np.empty_like(fin)
    for i, (b, f) in enumerate(zip(bgn, fin)):
        if b < T and low[b]:
            new_bgn[i] = run_start_at[b]
        elif b < T:
            # x[b] < low: the reference while-loop breaks before the first
            # decrement and appends bgn + 1.
            new_bgn[i] = b + 1
        else:
            # b == T can occur via the +1 run-start shift when a run starts
            # at the final frame; the pair is degenerate (fin < bgn) and is
            # dropped by the salt filter.
            new_bgn[i] = b
        if f < T and low[f]:
            new_fin[i] = run_end_at[f] + 1
        else:
            new_fin[i] = f
    return new_bgn, new_fin


def _smooth(bgn: np.ndarray, fin: np.ndarray, n_smooth: int):
    """Merge pairs whose gap to the original previous pair is <= n_smooth."""
    if bgn.size == 0:
        return bgn, fin
    gaps = bgn[1:] - fin[:-1]
    # group boundary where gap > n_smooth
    new_group = np.concatenate(([True], gaps > n_smooth))
    group_id = np.cumsum(new_group) - 1
    n_groups = group_id[-1] + 1
    out_bgn = np.empty(n_groups, np.int64)
    out_fin = np.empty(n_groups, np.int64)
    first = np.flatnonzero(new_group)
    last = np.concatenate((first[1:] - 1, [bgn.size - 1]))
    out_bgn[:] = bgn[first]
    out_fin[:] = fin[last]
    return out_bgn, out_fin


def _remove_salt(bgn: np.ndarray, fin: np.ndarray, n_salt: int):
    keep = (fin - bgn) > n_salt
    return bgn[keep], fin[keep]


def activity_detection_masks(high_mask, low_mask, n_smooth=1, n_salt=0):
    """Mask-based decode core: the full algorithm only consumes the two
    threshold-crossing masks (``x > high`` and ``x >= low``), never raw
    probabilities — which lets the serving engine ship packed bitmasks
    off-device instead of float tracks."""
    bgn, fin = _high_pairs_from_mask(np.asarray(high_mask))
    if low_mask is not None and bgn.size:
        bgn, fin = _extend_low_mask(np.asarray(low_mask), bgn, fin)
        bgn, fin = _smooth(bgn, fin, 1)
    bgn, fin = _smooth(bgn, fin, n_smooth)
    bgn, fin = _remove_salt(bgn, fin, n_salt)
    return [[int(b), int(f)] for b, f in zip(bgn, fin)]


def activity_detection(x, thres, low_thres=None, n_smooth=1, n_salt=0):
    """Decode one probability track into [bgn, fin] frame pairs.

    Matches ``utils/vad.py:11-45``.  Returns a list of [bgn, fin].
    """
    x = np.asarray(x)
    return activity_detection_masks(
        x > thres, (x >= low_thres) if low_thres is not None else None,
        n_smooth, n_salt)


def _vote_locations(x: np.ndarray, overlap_value: float, sample_duration: int):
    """Vote-count thresholding per overlap chunk (``utils/vad.py:47-106``).

    Returns a bool mask the same length as x: True where the vote count
    reaches the per-chunk number of overlapping windows.
    """
    T = x.shape[0]
    overlap_interval = int(100 * overlap_value)
    interval = (sample_duration * 100) - overlap_interval
    mask = np.zeros(T, bool)
    for i in range(0, T - overlap_interval, overlap_interval):
        if i < interval:
            num_overlaps = i // overlap_interval + 1
        elif i >= T - interval:
            num_overlaps = ((T - i) // overlap_interval) + 1
        else:
            num_overlaps = sample_duration
        chunk = x[i:i + overlap_interval]
        mask[i:i + overlap_interval] = chunk >= num_overlaps
    return mask


def activity_detection_binary(x, overlap_value, sample_duration, thres,
                              low_thres=None, n_smooth=1, n_salt=0):
    """Voting-pipeline decoder: chunk-wise vote threshold then the same
    pair post-processing.  Matches ``utils/vad.py:47-106``; the ``thres``
    argument is unused there too (votes are compared against the overlap
    count), and the low-threshold pass runs against the raw vote counts.
    """
    x = np.asarray(x)
    locts = np.flatnonzero(_vote_locations(x, overlap_value, sample_duration))
    # reconstruct pairs with the same run quirks as the high pass
    if locts.size == 0:
        bgn = fin = np.empty(0, np.int64)
    else:
        gap = np.flatnonzero(np.diff(locts) > 1)
        starts = locts[np.concatenate(([0], gap + 1))]
        ends = locts[np.concatenate((gap, [locts.size - 1]))]
        bgn = starts.copy()
        bgn[1:] += 1
        fin = ends + 1
        fin[-1] -= 1
    if low_thres is not None and bgn.size:
        # NB: the reference extends against raw vote counts here, so the
        # low mask is count >= low_thres
        bgn, fin = _extend_low_mask(x >= low_thres, bgn, fin)
        bgn, fin = _smooth(bgn, fin, 1)
    bgn, fin = _smooth(bgn, fin, n_smooth)
    bgn, fin = _remove_salt(bgn, fin, n_salt)
    return [[int(b), int(f)] for b, f in zip(bgn, fin)]
