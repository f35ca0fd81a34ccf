"""Average-precision metrics (sklearn-backed, like the reference; a copy
of ``sed_tpu/eval/ap.py``).

Mirrors ``pytorch/evaluate.py:11-29`` (framewise mAP on flattened
(N*T, C)) and the clipwise AP at ``pytorch/evaluate.py:76-77``.  sklearn
is imported where AP is computed, so the rest of the port runs without
it.
"""

from __future__ import annotations

import numpy as np


def clipwise_average_precision(target: np.ndarray, clipwise_output: np.ndarray,
                               average=None):
    from sklearn import metrics as sk_metrics
    return sk_metrics.average_precision_score(target, clipwise_output,
                                              average=average)


def sed_average_precision(strong_target: np.ndarray,
                          framewise_output: np.ndarray, average=None):
    """Framewise SED AP: flatten time into the sample axis."""
    from sklearn import metrics as sk_metrics
    assert strong_target.shape == framewise_output.shape
    (n, time_steps, classes_num) = strong_target.shape
    return sk_metrics.average_precision_score(
        strong_target.reshape((n * time_steps, classes_num)),
        framewise_output.reshape((n * time_steps, classes_num)),
        average=average)
