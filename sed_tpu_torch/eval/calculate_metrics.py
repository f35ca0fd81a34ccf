"""Micro P/R/F1 with per-class thresholds + results-dict extraction
(``utils/calculate_metrics.py:18-49``; a copy of
``sed_tpu/eval/calculate_metrics.py``).  sklearn is imported where the
scores are computed."""

from __future__ import annotations

import numpy as np


def calculate_precision_recall_f1(y_true: np.ndarray, output: np.ndarray,
                                  thresholds, average: str = 'micro'):
    from sklearn import metrics
    if y_true.ndim == 3:
        (n, t, f) = y_true.shape
        y_true = y_true.reshape((n * t, f))
        output = output.reshape((n * t, f))
    classes_num = y_true.shape[-1]
    binarized = np.zeros_like(output)
    for k in range(classes_num):
        binarized[:, k] = (np.sign(output[:, k] - thresholds[k]) + 1) // 2
    if average != 'micro':
        raise ValueError('Incorrect average argument!')
    precision = metrics.precision_score(y_true.flatten(),
                                        binarized.flatten())
    recall = metrics.recall_score(y_true.flatten(), binarized.flatten())
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return precision, recall, f1


def get_metric(results: dict, metric_type: str):
    if metric_type == 'f1':
        return results['overall']['f_measure']['f_measure']
    if metric_type == 'er':
        return results['overall']['error_rate']['error_rate']
    if metric_type == 'precision':
        return results['overall']['f_measure']['precision']
    if metric_type == 'recall':
        return results['overall']['f_measure']['recall']
    raise ValueError(f'unknown metric_type: {metric_type}')
