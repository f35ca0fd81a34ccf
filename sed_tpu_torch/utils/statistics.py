"""Evaluation statistics container (``utils/utilities.py:343-372``).

Pickle-appended eval statistics with a timestamped backup file and
iteration-truncating resume.  A copy of ``sed_tpu/utils/statistics.py``.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle


class StatisticsContainer:
    def __init__(self, statistics_path: str):
        self.statistics_path = statistics_path
        os.makedirs(os.path.dirname(statistics_path) or '.', exist_ok=True)
        stamp = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
        base, _ = os.path.splitext(statistics_path)
        self.backup_statistics_path = f'{base}_{stamp}.pkl'
        self.statistics_dict = {'train': [], 'test': [], 'valid': []}

    def append(self, data_type: str, iteration: int, statistics: dict):
        statistics = dict(statistics)
        statistics['iteration'] = iteration
        self.statistics_dict.setdefault(data_type, []).append(statistics)

    def dump(self):
        for path in (self.statistics_path, self.backup_statistics_path):
            with open(path, 'wb') as f:
                pickle.dump(self.statistics_dict, f)
        logging.info('    Dump statistics to %s', self.statistics_path)

    def load_state_dict(self, resume_iteration: int):
        """Reload and truncate statistics at a resume point.  (The
        reference resets to keys {'train','test','evaluate'} here —
        dropping 'valid' history — ``utilities.py:358-371``; we keep the
        original keys.)"""
        with open(self.statistics_path, 'rb') as f:
            loaded = pickle.load(f)
        self.statistics_dict = {
            key: [s for s in stats if s['iteration'] <= resume_iteration]
            for key, stats in loaded.items()}
