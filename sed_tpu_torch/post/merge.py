"""Overlap-add merging of sliding-window framewise probabilities.

``avg_merge`` replicates the reference's host-side
merge (``utils/utilities.py:405-446``).  ``overlap_add_windows`` is the
one-shot formulation: all windows of a file are merged with a
single vectorized overlap-add instead of the reference's per-window loop,
then coverage-normalized with avg_merge's exact chunk rule.

A copy of ``sed_tpu/post/merge.py``: the port keeps its own host modules
and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def coverage_counts(total_frames: int, sample_duration: int,
                    overlap_value: float = 1) -> np.ndarray:
    """Per-frame divisor used by ``avg_merge`` (``utils/utilities.py:425-446``).

    The reference divides interior chunks of ``100 * overlap_value`` frames
    by the number of windows covering them; frames before the first chunk
    boundary and at the very end keep divisor 1 (its loop starts at
    ``overlap_interval`` and stops before the last chunk).
    """
    overlap_interval = int(100 * overlap_value)
    interval = (sample_duration * 100) - overlap_interval
    div = np.ones(total_frames, np.float64)
    for i in range(overlap_interval, total_frames - overlap_interval,
                   overlap_interval):
        if i < interval:
            num_overlaps = i // overlap_interval + 1
        elif i >= total_frames - interval:
            num_overlaps = ((total_frames - i) // overlap_interval) + 1
        else:
            num_overlaps = sample_duration
        div[i:i + overlap_interval] = num_overlaps
    return div


def avg_merge(merged: np.ndarray, sample_duration: int,
              overlap_value: float = 1) -> np.ndarray:
    """Coverage-normalize an overlap-added track (in the reference this
    mutates in place; here it returns a new array)."""
    div = coverage_counts(merged.shape[1], sample_duration, overlap_value)
    return merged / div[None, :, None]


def overlap_add_windows(windows: np.ndarray, sample_duration: int,
                        overlap_value: float = 1,
                        normalize: bool = True) -> np.ndarray:
    """One-shot merge of all windows of a file.

    Args:
      windows: (num_windows, T_window, C) framewise probabilities, window i
        starting at frame ``i * 100 * overlap_value``.

    Returns:
      (1, total_frames, C) — identical to folding the reference's
      ``merge`` over the windows then applying ``avg_merge``.
    """
    num_windows, t_win, classes = windows.shape
    step = int(100 * overlap_value)
    total = t_win + (num_windows - 1) * step
    out = np.zeros((total, classes), windows.dtype)
    for i in range(num_windows):
        out[i * step:i * step + t_win] += windows[i]
    out = out[None]
    if normalize:
        # The reference applies avg_merge unconditionally, including for
        # single-window files (pytorch/predict.py:349).
        out = avg_merge(out, sample_duration, overlap_value)
    return out
