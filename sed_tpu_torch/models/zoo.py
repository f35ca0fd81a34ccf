"""CNN [+ BiGRU] + {max, avg, att} head SED models (counterpart of
``sed_tpu/models/zoo.py``).

``forward(wav) -> {'framewise_output' (B, T', C), 'clipwise_output'
(B, C), 'embedding'}`` at 100 output frames per second, the reference's
API.  Submodule names follow the flax parameter tree (``bn0``,
``conv_block1``.., ``gru``, ``att_block``, ``fc``), so
``compat/from_flax.py`` maps a checkpoint leaf by leaf.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.base import SedFeatureBase


class CnnSed(SedFeatureBase):
    """Conv blocks (the last one unpooled) -> mean over mel bins ->
    optional BiGRU -> attention head ('att') or per-frame sigmoid
    classifier ('max' / 'avg' clipwise pooling)."""

    def __init__(self, cfg, classes_num: int = 25,
                 feature_type: str = 'logmel',
                 conv_channels: Sequence[int] = (64, 128, 256, 512),
                 temporal: str = 'none', head: str = 'att',
                 gru_hidden: int = 256, pad_to_roundup: bool = False):
        super().__init__(cfg, feature_type)
        if temporal == 'multihead':
            raise NotImplementedError(
                "temporal='multihead' (MultiHead) is not ported yet: "
                'ROADMAP queue 1 item 6')
        if temporal not in ('none', 'gru'):
            raise ValueError(f'unknown temporal module: {temporal}')
        if head not in ('att', 'avg', 'max'):
            raise ValueError(f'unknown head: {head}')
        self.conv_channels = tuple(conv_channels)
        self.temporal = temporal
        self.head = head
        self.pad_to_roundup = pad_to_roundup
        in_ch = 1
        for i, ch in enumerate(self.conv_channels):
            self.add_module(f'conv_block{i + 1}', blocks.ConvBlock(in_ch, ch))
            in_ch = ch
        if temporal == 'gru':
            self.gru = blocks.BiGRU(in_ch, gru_hidden)
            in_ch = 2 * gru_hidden
        if head == 'att':
            self.att_block = blocks.AttBlock(in_ch, classes_num,
                                             activation='sigmoid')
        else:
            self.fc = nn.Linear(in_ch, classes_num)

    def forward(self, wav: torch.Tensor) -> dict:
        interpolate_ratio = 2 ** (len(self.conv_channels) - 1)
        x = self.compute_features(wav)                       # (B,1,T,F)
        for i in range(len(self.conv_channels)):
            last = i == len(self.conv_channels) - 1
            x = getattr(self, f'conv_block{i + 1}')(
                x, pool_size=(1, 1) if last else (2, 2), pool_type='avg')
        x = torch.mean(x, dim=3).transpose(1, 2)             # (B,T',C)

        if self.temporal == 'gru':
            x = self.gru(x)

        if self.head == 'att':
            clipwise, _norm_att, cla = self.att_block(x)
            framewise = blocks.interpolate(cla, interpolate_ratio)
            embedding = cla
        else:
            framewise = blocks.interpolate(torch.sigmoid(self.fc(x)),
                                           interpolate_ratio)
            if self.head == 'avg':
                clipwise = torch.mean(framewise, dim=1)
            else:
                clipwise = torch.amax(framewise, dim=1)
            embedding = x

        if self.pad_to_roundup and framewise.shape[1] != 1000:
            framewise = blocks.pad_framewise_output(
                framewise, blocks.roundup(framewise.shape[1]))

        return {'framewise_output': framewise,
                'clipwise_output': clipwise,
                'embedding': embedding}
