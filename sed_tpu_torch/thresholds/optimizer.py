"""Per-class SED threshold optimization (a copy of
``sed_tpu/thresholds/optimizer.py``).

Black-box gradient ascent on F1 with numerically-estimated gradients and
a plain-numpy Adam, matching ``utils/optimize_thresholds.py:31-207``:

* gradient of param k: bump by ``step`` up to ``max_search`` times until
  the score moves, then (new - old) / (step * cnt);
* gradients are negated and fed to a minimizing Adam ("fast Adam" with
  folded bias correction, ``optimize_thresholds.py:110-140``);
* the SED score is the official segment-based F1 of events decoded from
  cached validation predictions with the candidate 75-dim threshold
  vector (25 tagging + 25 high + 25 low).
"""

from __future__ import annotations

import pickle
import time
from typing import Callable, List, Optional

import numpy as np

import sed_tpu_torch.post.events as post_events
from sed_tpu_torch.eval import segment_metrics
from sed_tpu_torch.eval.calculate_metrics import \
    calculate_precision_recall_f1


class Adam:
    """Numpy AMS-free Adam with folded bias correction
    (``optimize_thresholds.py:110-140``)."""

    def __init__(self, alpha: float = 1e-3):
        self.ms: List[np.ndarray] = []
        self.vs: List[np.ndarray] = []
        self.alpha = alpha
        self.beta1 = 0.9
        self.beta2 = 0.999
        self.eps = 1e-8
        self.iter = 0

    def step(self, params: List[float], grads: List[float]) -> List[float]:
        if not self.ms:
            self.ms = [np.zeros_like(p) for p in params]
            self.vs = [np.zeros_like(p) for p in params]
        self.iter += 1
        alpha_t = self.alpha * np.sqrt(
            1 - self.beta2 ** self.iter) / (1 - self.beta1 ** self.iter)
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.ms[i] = self.beta1 * self.ms[i] + (1 - self.beta1) * g
            self.vs[i] = (self.beta2 * self.vs[i]
                          + (1 - self.beta2) * np.square(g))
            out.append(p - alpha_t * self.ms[i]
                       / np.sqrt(self.vs[i] + self.eps))
        return out


class HyperParamsOptimizer:
    """Numerical-gradient ascent loop
    (``optimize_thresholds.py:31-101``); defaults match the SED run
    (70 epochs, lr 1e-2, step 0.02, ``optimize_thresholds.py:479-480``)."""

    def __init__(self, score_calculator: Callable[[List[float]], float],
                 learning_rate: float = 1e-2, epochs: int = 70,
                 step: float = 0.02, max_search: int = 5,
                 save_dict: Optional[dict] = None):
        self.score_calculator = score_calculator
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.optimizer = Adam(alpha=learning_rate)
        self.step = step
        self.max_search = max_search
        self.save_dict = save_dict if save_dict is not None else {}

    def do_optimize(self, init_params: List[float]):
        print('Optimizing hyper parameters ...')
        print('learning rate: {:.3f}, total epochs: {}'.format(
            self.learning_rate, self.epochs))
        params = list(init_params)
        score = 0.0
        for i in range(self.epochs):
            t0 = time.time()
            score, grads = self.calculate_gradients(params)
            params = self.optimizer.step(params, [-g for g in grads])
            self.save_dict[i] = {'thresholds': params, 'score': score}
            print('    Hyper parameters: {}, score: {:.4f}'.format(
                [round(float(p), 4) for p in params], score))
            print('    Epoch: {}, Time: {:.4f} s'.format(
                i, time.time() - t0))
        return score, params, self.save_dict

    def calculate_gradients(self, params: List[float]):
        score = self.score_calculator(params)
        grads = []
        for k in range(len(params)):
            new_params = list(params)
            cnt = 0
            new_score = score
            while cnt < self.max_search:
                cnt += 1
                new_params[k] += self.step
                new_score = self.score_calculator(new_params)
                if new_score != score:
                    break
            grads.append((new_score - score) / (self.step * cnt))
        return score, grads


class AudioTaggingScoreCalculator:
    """Clipwise F1 from cached predictions
    (``optimize_thresholds.py:143-157``)."""

    def __init__(self, prediction_path: str):
        with open(prediction_path, 'rb') as f:
            self.output_dict = pickle.load(f)

    def __call__(self, params: List[float]) -> float:
        _, _, f1 = calculate_precision_recall_f1(
            self.output_dict['target'], self.output_dict['clipwise_output'],
            thresholds=params)
        return f1


class SoundEventDetectionScoreCalculator:
    """Segment-based F1 from cached predictions + candidate thresholds
    (``optimize_thresholds.py:160-207``)."""

    def __init__(self, prediction_path: str, reference_csv_path: str,
                 submission_path: str, classes_num: int,
                 frames_per_second: int):
        with open(prediction_path, 'rb') as f:
            self.output_dict = pickle.load(f)
        self.reference_csv_path = reference_csv_path
        self.submission_path = submission_path
        self.classes_num = classes_num
        self.frames_per_second = frames_per_second

    def params_dict_to_params_list(self, d: dict) -> List[float]:
        return (list(d['audio_tagging_threshold'])
                + list(d['sed_high_threshold'])
                + list(d['sed_low_threshold']))

    def params_list_to_params_dict(self, params: List[float]) -> dict:
        c = self.classes_num
        return {
            'audio_tagging_threshold': list(params[0:c]),
            'sed_high_threshold': list(params[c:2 * c]),
            'sed_low_threshold': list(params[2 * c:]),
            'n_smooth': 10,
            'n_salt': 10,
        }

    def __call__(self, params: List[float]) -> float:
        params_dict = self.params_list_to_params_dict(params)
        event_list = post_events.frame_prediction_to_event_prediction(
            self.output_dict, params_dict, self.frames_per_second)
        post_events.write_submission(event_list, self.submission_path)
        results = segment_metrics.official_evaluate(
            self.reference_csv_path, self.submission_path)
        return results['overall']['f_measure']['f_measure']
