"""Shared SED model preamble: log-mel frontend (or precomputed gammatone
features), ``bn0`` and train-time augmentation (counterpart of
``sed_tpu/models/base.py``).

With ``feature_type='logmel'`` the frontend is ``fused_logmel``: the
CUDA kernel for a tensor on the GPU, its plain PyTorch version for a
tensor on the CPU.  With ``feature_type='gamma'`` the input is the
packed (B, mel_bins, T) gammatonegram (``dsp/gammatone.fft_gtgram_db``,
as the HDF5 path ships it: int16 / 32767) and no frontend runs
(``pytorch/models.py:630-640``).  ``bn0`` is a
BatchNorm over the mel bins (axis 2 of the reference's (B, T, F, 1)); a
model built with ``skip_bn0`` (VGGish, whose reference comments it out)
has no such module and no tensors of it.
In training mode ``bn0`` uses batch statistics and the augmentations
run in ``sed_tpu``'s order: SpecAugment, then mixup (timeshift first
when both are on) or timeshift alone.

``compute_dtype`` is ``sed_tpu``'s field of the same name: the dtype of
the conv stack (``torch.bfloat16``), which ``CnnSed`` hands to its
ConvBlocks.  The log-mel frontend, ``bn0`` and everything after the
stack stay float32.  The other families store it and, as in
``sed_tpu``, never read it: their convolutions stay float32, which they
log once when built.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
from torch import nn

from sed_tpu_torch.augment import functional as aug
from sed_tpu_torch.models.blocks import BatchNorm
from sed_tpu_torch.ops.logmel_kernel import fused_logmel


class SedFeatureBase(nn.Module):
    """Waveform (B, samples) -> normalised log-mel (B, 1, T, F), or
    gammatone features (B, F, T) -> normalised (B, 1, T, F).

    BatchNorm momentum 0.1 in torch is flax's 0.9; eps 1e-5 as in the
    reference.
    """

    # top-level modules that the reference's class of this model holds
    # and never runs: a reference ``.pth`` has their tensors, the port's
    # model does not (``compat/from_flax.load_checkpoint`` drops them)
    reference_unused: tuple = ()
    # whether the class runs its convolutions in ``compute_dtype``
    runs_compute_dtype: bool = False

    def __init__(self, cfg, feature_type: str = 'logmel',
                 skip_bn0: bool = False, compute_dtype=None):
        super().__init__()
        if feature_type not in ('logmel', 'gamma'):
            raise ValueError(f'unsupported feature_type: {feature_type}')
        self.cfg = cfg
        self.feature_type = feature_type
        self.compute_dtype = compute_dtype
        if compute_dtype is not None and not self.runs_compute_dtype:
            logging.info('%s: compute_dtype %s is stored, but its '
                         'convolutions stay float32 (as in sed_tpu)',
                         type(self).__name__, compute_dtype)
        self.bn0 = None if skip_bn0 else BatchNorm(cfg.mel_bins)

    def compute_features(self, wav: torch.Tensor,
                         mixup_lambda: Optional[torch.Tensor] = None,
                         timeshift: bool = False, spec_augment: bool = True,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        if self.feature_type == 'logmel':
            x = fused_logmel(wav, self.cfg).transpose(1, 2)  # (B, F, T)
        else:
            x = wav                                          # (B, F, T)
        if self.bn0 is not None:
            x = self.bn0(x)
        x = x.transpose(1, 2)[:, None]                      # (B, 1, T, F)
        if not self.training:
            return x
        if spec_augment:
            x = aug.spec_augment(x, generator)
        if mixup_lambda is not None:
            if timeshift:
                x = aug.do_mixup_timeshift(x, mixup_lambda, generator)
            else:
                x = aug.do_mixup(x, mixup_lambda)
        elif timeshift:
            x = aug.do_timeshift(x, generator)
        return x
