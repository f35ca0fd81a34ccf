"""Shared SED model preamble: log-mel frontend + ``bn0`` (counterpart of
``sed_tpu/models/base.py``, eval path only).

The frontend is ``fused_logmel``: the CUDA kernel for a tensor on the
GPU, its plain PyTorch version for a tensor on the CPU.  ``bn0`` is a
BatchNorm over the mel bins (axis 2 of the reference's (B, T, F, 1)).
Train-time augmentation (SpecAugment, mixup, timeshift) is not ported
yet, so a forward in training mode raises.
"""

from __future__ import annotations

import torch
from torch import nn

from sed_tpu_torch.ops.logmel_kernel import fused_logmel


class SedFeatureBase(nn.Module):
    """Waveform (B, samples) -> normalised log-mel (B, 1, T, F).

    BatchNorm momentum 0.1 in torch is flax's 0.9; eps 1e-5 as in the
    reference.
    """

    def __init__(self, cfg, feature_type: str = 'logmel'):
        super().__init__()
        if feature_type != 'logmel':
            raise NotImplementedError(
                f'feature_type {feature_type!r}: only logmel is ported')
        self.cfg = cfg
        self.bn0 = nn.BatchNorm1d(cfg.mel_bins, eps=1e-5, momentum=0.1)

    def compute_features(self, wav: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                'training-mode forward (augmentation, batch statistics) '
                'is not ported yet: call .eval() first')
        x = fused_logmel(wav, self.cfg)                     # (B, T, F)
        x = self.bn0(x.transpose(1, 2)).transpose(1, 2)
        return x[:, None]                                   # (B, 1, T, F)
