"""Workspace artifact path conventions.

The reference builds the same nested directory scheme in every entry
point (``pytorch/main_strong.py:116-187``, ``pytorch/predict.py:206-257``):

  <workspace>/<kind>/<filename>/holdout_fold=H/model_type=M/loss_type=L/
      augmentation=A/batch_size=B/...

with kinds checkpoints / predictions / opt_thresholds / _tmp_submission /
statistics / logs.  One class owns it here.

A copy of ``sed_tpu/utils/paths.py``: the port keeps its own host modules
and imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Workspace:
    root: str
    filename: str = 'main_strong'
    holdout_fold: str = '1'
    model_type: str = 'Cnn_9layers_Gru_FrameAtt'
    loss_type: str = 'clip_bce'
    augmentation: str = 'specaugment_timeshift_mixup'
    batch_size: int = 32

    def _leaf(self, kind: str) -> str:
        return os.path.join(
            self.root, kind, self.filename,
            f'holdout_fold={self.holdout_fold}',
            f'model_type={self.model_type}',
            f'loss_type={self.loss_type}',
            f'augmentation={self.augmentation}',
            f'batch_size={self.batch_size}')

    def dir(self, kind: str, create: bool = False) -> str:
        path = self._leaf(kind)
        if create:
            os.makedirs(path, exist_ok=True)
        return path

    # -- named artifacts ----------------------------------------------------

    def checkpoint_path(self, feature_type: str, quality: str,
                        create: bool = False) -> str:
        """``best_{feat}_{quality}`` checkpoint directory/file stem
        (``main_strong.py:326-334``)."""
        return os.path.join(self.dir('checkpoints', create),
                            f'best_{feature_type}_{quality}')

    def torch_checkpoint_path(self, feature_type: str, quality: str) -> str:
        return self.checkpoint_path(feature_type, quality) + '.pth'

    def sed_thresholds_path(self, feature_type: str, quality: str,
                            create: bool = False) -> str:
        """Optimized-threshold pickle (``optimize_thresholds.py:459-463``)."""
        return os.path.join(
            self.dir('opt_thresholds', create),
            f'best_{feature_type}_{quality}.sed.valid.pkl')

    def submission_path(self, create: bool = False) -> str:
        return os.path.join(self.dir('_tmp_submission', create),
                            '_submission.csv')

    def predictions_path(self, name: str, create: bool = False) -> str:
        return os.path.join(self.dir('predictions', create), name)

    def statistics_path(self, feature_type: str, quality: str,
                        create: bool = False) -> str:
        return os.path.join(self.dir('statistics', create),
                            f'statistics_{feature_type}_{quality}.pkl')

    def logs_dir(self, create: bool = False) -> str:
        return self.dir('logs', create)

    def predict_results_dir(self, create: bool = False) -> str:
        path = os.path.join(self.root, 'predict_results')
        if create:
            os.makedirs(path, exist_ok=True)
        return path
