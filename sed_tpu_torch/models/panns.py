"""PANNs CNN14 with decision-level attention (counterpart of
``sed_tpu/models/panns.py``).

6 ConvBlocks (time / 32) with dropout 0.2 after each, a 3-wide max + avg
temporal smoothing, fc 2048 -> 2048 + ReLU between dropouts of 0.5, the
attention head, x32 interpolation, padded to ``samples // hop`` frames
(1000 for a 10 s clip), or to ``T - 1`` for T gammatone frames (993 for a
packed 10 s clip).

The 3-wide pools pad one frame each side: the max pool with -inf, the
average pool with zeros that it counts (the edges divide by 3), as
flax's ``avg_pool`` with explicit padding does.

``conv_channels`` narrows the stack (tests and rehearsals); the
interpolation repeats each frame 2^(blocks - 1) times, 32 at the
published six blocks.  Everything after the conv stack (smoothing, fc1,
attention, interpolation and pad) runs inside a ``sed::panns.head``
span.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.base import SedFeatureBase
from sed_tpu_torch.utils.profiling import span


class Cnn14DecisionLevelAtt(SedFeatureBase):
    conv_channels = (64, 128, 256, 512, 1024, 2048)

    def __init__(self, cfg, classes_num: int = 25,
                 feature_type: str = 'logmel', block_dropout: float = 0.2,
                 fc_dropout: float = 0.5, compute_dtype=None,
                 conv_channels=None):
        super().__init__(cfg, feature_type, compute_dtype=compute_dtype)
        if conv_channels is not None:
            self.conv_channels = tuple(conv_channels)
        self.block_dropout = block_dropout
        self.fc_dropout = fc_dropout
        in_ch = 1
        for i, ch in enumerate(self.conv_channels):
            self.add_module(f'conv_block{i + 1}', blocks.ConvBlock(in_ch, ch))
            in_ch = ch
        self.fc1 = nn.Linear(in_ch, 2048)
        self.att_block = blocks.AttBlock(2048, classes_num,
                                         activation='sigmoid')

    def forward(self, wav: torch.Tensor,
                mixup_lambda: Optional[torch.Tensor] = None,
                timeshift: bool = False, spec_augment: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        frames_num = (wav.shape[-1] // self.cfg.hop_size
                      if self.feature_type == 'logmel' else wav.shape[-1] - 1)
        x = self.compute_features(wav, mixup_lambda, timeshift,
                                  spec_augment, generator)
        last = len(self.conv_channels) - 1
        for i in range(len(self.conv_channels)):
            x = getattr(self, f'conv_block{i + 1}')(
                x, pool_size=(1, 1) if i == last else (2, 2),
                pool_type='avg')
            if self.training:
                x = blocks.dropout(x, self.block_dropout, generator)
        x = torch.mean(x, dim=3)                             # (B, 2048, T')
        with span('panns.head'):
            return self._head(x, frames_num, generator)

    def _head(self, x: torch.Tensor, frames_num: int,
              generator: Optional[torch.Generator]) -> dict:
        x = F.max_pool1d(x, 3, stride=1, padding=1) + F.avg_pool1d(
            x, 3, stride=1, padding=1, count_include_pad=True)
        x = x.transpose(1, 2)                                # (B, T', 2048)
        if self.training:
            x = blocks.dropout(x, self.fc_dropout, generator)
        x = F.relu(self.fc1(x))
        if self.training:
            x = blocks.dropout(x, self.fc_dropout, generator)

        clipwise, _, segmentwise = self.att_block(x)
        framewise = blocks.interpolate(segmentwise,
                                       2 ** (len(self.conv_channels) - 1))
        if framewise.shape[1] < frames_num:
            framewise = blocks.pad_framewise_output(framewise, frames_num)
        return {'framewise_output': framewise,
                'clipwise_output': clipwise,
                'embedding': segmentwise}
