"""Segment-based SED metrics (Error Rate / F1), sed_eval-compatible.

The reference delegates its headline metric to
``sed_eval.sound_event.SegmentBasedMetrics(time_resolution=1.0)``
(``utils/utilities.py:294-340``).  That package is reimplemented here from
the published DCASE segment-metric definition (Mesaros et al., "Metrics
for polyphonic sound event detection", 2016):

* per file, the timeline is split into ``time_resolution``-second
  segments out to the latest reference/estimated offset;
* an event is active in every segment it overlaps, via
  onset -> floor(onset/res), offset -> ceil(offset/res);
* per segment: Ntp/Nfp/Nfn, substitutions S = min(Nref, Nsys) - Ntp,
  deletions D = max(0, Nref - Nsys), insertions I = max(0, Nsys - Nref);
* overall ER = (S + D + I) / Nref, micro P/R/F1 from Ntp/Nsys/Nref;
* class-wise ER_c = (Nfn_c + Nfp_c) / Nref_c, macro-averaged F1.

The ``results()`` dict mirrors sed_eval's layout because downstream code
indexes it the same way the reference does
(``utils/calculate_metrics.py:41-49``).

A copy of ``sed_tpu/eval/segment_metrics.py``: the port keeps its own host modules
and imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Sequence

import numpy as np

from sed_tpu_torch import config as cfg


def _event_roll(event_list: List[dict], label_index: Dict[str, int],
                n_segments: int, time_resolution: float) -> np.ndarray:
    roll = np.zeros((n_segments, len(label_index)), dtype=bool)
    for event in event_list:
        k = label_index.get(event['event_label'])
        if k is None:
            continue
        on = int(math.floor(float(event['onset']) / time_resolution))
        off = int(math.ceil(float(event['offset']) / time_resolution))
        roll[on:off, k] = True
    return roll


def _max_offset(event_list: List[dict]) -> float:
    out = 0.0
    for event in event_list:
        out = max(out, float(event['offset']))
    return out


class SegmentBasedMetrics:
    """Accumulating segment-based metrics over per-file evaluate() calls."""

    def __init__(self, event_label_list: Sequence[str] = cfg.LABELS,
                 time_resolution: float = 1.0):
        self.labels = list(event_label_list)
        self.label_index = {lb: i for i, lb in enumerate(self.labels)}
        self.time_resolution = float(time_resolution)
        C = len(self.labels)
        self.overall = {'Ntp': 0.0, 'Ntn': 0.0, 'Nfp': 0.0, 'Nfn': 0.0,
                        'Nref': 0.0, 'Nsys': 0.0, 'ER': 0.0, 'S': 0.0,
                        'D': 0.0, 'I': 0.0}
        self.class_wise = {
            key: np.zeros(C) for key in
            ('Ntp', 'Ntn', 'Nfp', 'Nfn', 'Nref', 'Nsys')}

    def evaluate(self, reference_event_list: List[dict],
                 estimated_event_list: List[dict]) -> 'SegmentBasedMetrics':
        res = self.time_resolution
        length_s = max(_max_offset(reference_event_list),
                       _max_offset(estimated_event_list))
        n_segments = int(math.ceil(length_s / res))
        ref = _event_roll(reference_event_list, self.label_index,
                          n_segments, res)
        est = _event_roll(estimated_event_list, self.label_index,
                          n_segments, res)

        tp = ref & est
        fp = est & ~ref
        fn = ref & ~est
        tn = ~ref & ~est

        nref_seg = ref.sum(axis=1).astype(np.float64)
        nsys_seg = est.sum(axis=1).astype(np.float64)
        ntp_seg = tp.sum(axis=1).astype(np.float64)

        self.overall['Ntp'] += float(ntp_seg.sum())
        self.overall['Ntn'] += float(tn.sum())
        self.overall['Nfp'] += float(fp.sum())
        self.overall['Nfn'] += float(fn.sum())
        self.overall['Nref'] += float(nref_seg.sum())
        self.overall['Nsys'] += float(nsys_seg.sum())
        self.overall['S'] += float(np.sum(np.minimum(nref_seg, nsys_seg)
                                          - ntp_seg))
        self.overall['D'] += float(np.sum(np.maximum(0.0,
                                                     nref_seg - nsys_seg)))
        self.overall['I'] += float(np.sum(np.maximum(0.0,
                                                     nsys_seg - nref_seg)))

        self.class_wise['Ntp'] += tp.sum(axis=0)
        self.class_wise['Ntn'] += tn.sum(axis=0)
        self.class_wise['Nfp'] += fp.sum(axis=0)
        self.class_wise['Nfn'] += fn.sum(axis=0)
        self.class_wise['Nref'] += ref.sum(axis=0)
        self.class_wise['Nsys'] += est.sum(axis=0)
        return self

    # -- result assembly (sed_eval-compatible layout) ----------------------

    @staticmethod
    def _f_measure(ntp: float, nsys: float, nref: float) -> dict:
        precision = ntp / nsys if nsys > 0 else 0.0
        recall = ntp / nref if nref > 0 else 0.0
        if precision + recall > 0:
            f_measure = 2 * precision * recall / (precision + recall)
        else:
            f_measure = 0.0
        return {'f_measure': f_measure, 'precision': precision,
                'recall': recall}

    def results(self) -> dict:
        ov = self.overall
        nref = ov['Nref'] if ov['Nref'] > 0 else 1.0
        overall = {
            'f_measure': self._f_measure(ov['Ntp'], ov['Nsys'], ov['Nref']),
            'error_rate': {
                'error_rate': (ov['S'] + ov['D'] + ov['I']) / nref,
                'substitution_rate': ov['S'] / nref,
                'deletion_rate': ov['D'] / nref,
                'insertion_rate': ov['I'] / nref,
            },
            'accuracy': self._accuracy(ov['Ntp'], ov['Ntn'], ov['Nfp'],
                                       ov['Nfn']),
        }

        class_wise = {}
        avg_lists: Dict[str, List[float]] = {
            k: [] for k in ('f_measure', 'precision', 'recall',
                            'error_rate', 'deletion_rate',
                            'insertion_rate')}
        for i, lb in enumerate(self.labels):
            cw = {k: float(v[i]) for k, v in self.class_wise.items()}
            nref_c = cw['Nref'] if cw['Nref'] > 0 else 1.0
            fm = self._f_measure(cw['Ntp'], cw['Nsys'], cw['Nref'])
            er = {
                'error_rate': (cw['Nfn'] + cw['Nfp']) / nref_c,
                'deletion_rate': cw['Nfn'] / nref_c,
                'insertion_rate': cw['Nfp'] / nref_c,
            }
            class_wise[lb] = {
                'count': {'Nref': cw['Nref'], 'Nsys': cw['Nsys']},
                'f_measure': fm,
                'error_rate': er,
                'accuracy': self._accuracy(cw['Ntp'], cw['Ntn'], cw['Nfp'],
                                           cw['Nfn']),
            }
            # macro averages over classes present in the reference
            if self.class_wise['Nref'][i] > 0:
                for k in ('f_measure', 'precision', 'recall'):
                    avg_lists[k].append(fm[k])
                for k in ('error_rate', 'deletion_rate', 'insertion_rate'):
                    avg_lists[k].append(er[k])

        def _mean(key):
            return float(np.mean(avg_lists[key])) if avg_lists[key] else 0.0

        class_wise_average = {
            'f_measure': {
                'f_measure': _mean('f_measure'),
                'precision': _mean('precision'),
                'recall': _mean('recall'),
            },
            'error_rate': {
                'error_rate': _mean('error_rate'),
                'deletion_rate': _mean('deletion_rate'),
                'insertion_rate': _mean('insertion_rate'),
            },
        }
        return {'overall': overall, 'class_wise': class_wise,
                'class_wise_average': class_wise_average}

    @staticmethod
    def _accuracy(ntp, ntn, nfp, nfn) -> dict:
        total = ntp + ntn + nfp + nfn
        acc = (ntp + ntn) / total if total > 0 else 0.0
        # balanced accuracy / sensitivity / specificity as in sed_eval
        sensitivity = ntp / (ntp + nfn) if (ntp + nfn) > 0 else 0.0
        specificity = ntn / (ntn + nfp) if (ntn + nfp) > 0 else 0.0
        return {'accuracy': acc, 'sensitivity': sensitivity,
                'specificity': specificity,
                'balanced_accuracy': 0.5 * (sensitivity + specificity)}


def load_event_list_csv(path: str, delimiter: str = ',') -> List[dict]:
    """Load a filename/onset/offset/label CSV (sed_eval.io.load_event_list
    with ``fields=['filename','onset','offset','event_label']``)."""
    events = []
    with open(path, 'r') as f:
        for row in csv.reader(f, delimiter=delimiter):
            if not row:
                continue
            events.append({
                'filename': row[0],
                'onset': float(row[1]),
                'offset': float(row[2]),
                'event_label': row[3],
            })
    return events


def official_evaluate(reference_csv_path: str, prediction_csv_path: str,
                      labels: Sequence[str] = cfg.LABELS) -> dict:
    """Corpus evaluation matching ``utils/utilities.py:294-340``: group
    events per file (file set defined by the reference list), evaluate
    each file, return the accumulated results dict."""
    reference_event_list = load_event_list_csv(reference_csv_path,
                                               delimiter=',')
    estimated_event_list = load_event_list_csv(prediction_csv_path,
                                               delimiter='\t')

    ref_by_file: Dict[str, List[dict]] = {}
    for event in reference_event_list:
        ref_by_file.setdefault(event['filename'], []).append(event)
    est_by_file: Dict[str, List[dict]] = {}
    for event in estimated_event_list:
        est_by_file.setdefault(event['filename'], []).append(event)

    metrics = SegmentBasedMetrics(event_label_list=labels,
                                  time_resolution=1.0)
    for file in sorted(ref_by_file.keys()):
        metrics.evaluate(
            reference_event_list=ref_by_file[file],
            estimated_event_list=est_by_file.get(file, []))
    return metrics.results()
