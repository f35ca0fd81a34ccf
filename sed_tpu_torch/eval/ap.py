"""Average-precision metrics, in numpy (counterpart of
``sed_tpu/eval/ap.py``, which calls sklearn).

Mirrors ``pytorch/evaluate.py:11-29`` (framewise mAP on flattened
(N*T, C)) and the clipwise AP at ``pytorch/evaluate.py:76-77``.

The port computes AP itself, with the steps of
``sklearn.metrics.average_precision_score(average=None)`` per column and
bit-equal to it: the machine the port trains on has no sklearn, and the
training loop's ``Evaluator`` needs AP at every evaluation.  A column
with no positive gives 0.0, as sklearn gives it (without sklearn's
warning).
"""

from __future__ import annotations

import numpy as np


def binary_average_precision(y_true: np.ndarray,
                             y_score: np.ndarray) -> float:
    """AP of one column: the step integral of the precision-recall
    curve, as sklearn's ``_binary_uninterpolated_average_precision``."""
    order = np.argsort(y_score, kind='mergesort')[::-1]   # stable, descending
    score = y_score[order]
    true = (y_true[order] == 1).astype(np.float64)
    # thresholds where the sorted score changes, and the last row
    idx = np.r_[np.nonzero(np.diff(score))[0], true.size - 1]
    tps = np.cumsum(true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    ps = tps + fps
    precision = np.where(ps != 0, np.divide(tps, ps), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate((precision[::-1], [1.0]))
    recall = np.concatenate((recall[::-1], [0.0]))
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _per_column(target: np.ndarray, output: np.ndarray,
                average) -> np.ndarray:
    """AP of each column (``average=None``, the only average the port
    computes)."""
    if average is not None:
        raise ValueError(f'average={average!r}: the port computes AP per '
                         'class only (average=None)')
    target, output = np.asarray(target), np.asarray(output)
    assert target.shape == output.shape and target.ndim == 2
    return np.array([binary_average_precision(target[:, c], output[:, c])
                     for c in range(target.shape[1])])


def clipwise_average_precision(target: np.ndarray, clipwise_output: np.ndarray,
                               average=None):
    return _per_column(target, clipwise_output, average)


def sed_average_precision(strong_target: np.ndarray,
                          framewise_output: np.ndarray, average=None):
    """Framewise SED AP: flatten time into the sample axis."""
    assert strong_target.shape == framewise_output.shape
    (n, time_steps, classes_num) = strong_target.shape
    return _per_column(
        np.reshape(strong_target, (n * time_steps, classes_num)),
        np.reshape(framewise_output, (n * time_steps, classes_num)), average)
