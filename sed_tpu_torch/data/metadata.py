"""Label CSV parsing and target construction (a copy of
``sed_tpu/data/metadata.py``).

Format parity with ``utils/features.py:20-176``:

* weak rows: ``ytid,start,end,"lab1,lab2",ids`` -> clip name
  ``<ytid>_<int(start)>.wav`` and a multi-hot (classes,) target;
* evaluation rows are tab-separated ``wav, onset, offset, label`` with one
  label per row, merged per file;
* strong rows: ``wav,onset,offset,label`` -> frame grid (frames, classes)
  at 100 fps with end frame ``round(offset * fps) + 1``.
"""

from __future__ import annotations

import csv
import re
from typing import Dict, List

import numpy as np

from sed_tpu_torch import config as cfg


def get_weak_csv_filename(data_type: str) -> str:
    """Metadata file layout (``utils/features.py:20-36``)."""
    if data_type in ('training', 'testing'):
        return f'{data_type}_set.csv'
    if data_type in ('weak_training', 'strong_training', 'strong_fsd50k',
                     'strong_validation'):
        return f'strong/{data_type}_set.csv'
    if data_type == 'evaluation':
        return 'groundtruth_weak_label_evaluation_set.csv'
    raise ValueError(f'Incorrect data_type: {data_type}')


def read_weak_csv(path: str, data_type: str) -> List[dict]:
    """Weakly-labelled metadata -> [{'audio_name', 'labels'}, ...]."""
    comma_types = ('training', 'testing', 'weak_training',
                   'strong_training', 'strong_validation', 'strong_fsd50k')
    if data_type in comma_types:
        delimiter = ','
    elif data_type == 'evaluation':
        delimiter = '\t'
    else:
        raise ValueError(f'Incorrect data_type: {data_type}')

    with open(path, 'r') as f:
        rows = list(csv.reader(f, delimiter=delimiter))

    meta_list: List[dict] = []
    if data_type == 'evaluation':
        by_name: Dict[str, dict] = {}
        for row in rows:
            name = row[0]
            if name in by_name:
                by_name[name]['labels'].append(row[3])
            else:
                meta = {'audio_name': name, 'labels': [row[3]]}
                by_name[name] = meta
                meta_list.append(meta)
    elif data_type == 'strong_fsd50k':
        for row in rows:
            meta_list.append({
                'audio_name': row[0] + '.wav',
                'labels': re.split(',(?! )', row[3])})
    else:
        for row in rows:
            meta_list.append({
                'audio_name': f'{row[0]}_{int(float(row[1]))}.wav',
                'labels': re.split(',(?! )', row[3])})
    return meta_list


def read_strong_csv(path: str) -> Dict[str, List[dict]]:
    """Strong metadata -> {'a.wav': [{'onset','offset','label'}, ...]}."""
    with open(path, 'r') as f:
        rows = list(csv.reader(f, delimiter=','))
    meta_dict: Dict[str, List[dict]] = {}
    for audio_name, onset, offset, label in rows:
        meta_dict.setdefault(audio_name, []).append(
            {'onset': onset, 'offset': offset, 'label': label})
    return meta_dict


def get_weak_target(labels: List[str],
                    lb_to_idx: Dict[str, int] = cfg.LB_TO_IDX) -> np.ndarray:
    target = np.zeros(len(lb_to_idx), dtype=bool)
    for label in labels:
        target[lb_to_idx[label]] = True
    return target


def get_strong_target(audio_name: str, strong_meta_dict: Dict[str, List[dict]],
                      frames_num: int, frames_per_second: int,
                      lb_to_idx: Dict[str, int] = cfg.LB_TO_IDX) -> np.ndarray:
    """Frame-grid target; end frame = round(offset * fps) + 1
    (``utils/features.py:145-176``)."""
    target = np.zeros((frames_num, len(lb_to_idx)), dtype=bool)
    for meta in strong_meta_dict.get(audio_name, []):
        bgn = int(round(float(meta['onset']) * frames_per_second))
        end = int(round(float(meta['offset']) * frames_per_second)) + 1
        target[bgn:end, lb_to_idx[meta['label']]] = True
    return target
