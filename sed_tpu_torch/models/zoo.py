"""CNN [+ BiGRU | + MultiHead] + {max, avg, att} head SED models
(counterpart of ``sed_tpu/models/zoo.py``).

``forward(wav, mixup_lambda=None, timeshift=False, spec_augment=True,
generator=None) -> {'framewise_output' (B, T', C), 'clipwise_output'
(B, C), 'embedding'}`` at 100 output frames per second, the reference's
API.  The augmentation flags and the dropouts act in training mode
only, with every draw from ``generator``; with mixup the batch halves.
``compute_dtype=torch.bfloat16`` runs the ConvBlocks' convolutions in
bf16 (``sed_tpu/models/zoo.py:63-68``); the rest stays float32.
Submodule names follow the flax parameter tree (``bn0``,
``conv_block1``.., ``gru``, ``multihead``, ``att_block``, ``fc``), so
``compat/from_flax.py`` maps a checkpoint leaf by leaf.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.base import SedFeatureBase


class CnnSed(SedFeatureBase):
    """Conv blocks (the last one unpooled) -> mean over mel bins ->
    optional BiGRU ('gru') or self-attention block ('multihead') ->
    attention head ('att') or per-frame sigmoid classifier ('max' /
    'avg' clipwise pooling)."""

    runs_compute_dtype = True

    def __init__(self, cfg, classes_num: int = 25,
                 feature_type: str = 'logmel',
                 conv_channels: Sequence[int] = (64, 128, 256, 512),
                 temporal: str = 'none', head: str = 'att',
                 gru_hidden: int = 256, pad_to_roundup: bool = False,
                 compute_dtype=None):
        super().__init__(cfg, feature_type, compute_dtype=compute_dtype)
        if temporal not in ('none', 'gru', 'multihead'):
            raise ValueError(f'unknown temporal module: {temporal}')
        if head not in ('att', 'avg', 'max'):
            raise ValueError(f'unknown head: {head}')
        self.conv_channels = tuple(conv_channels)
        self.temporal = temporal
        self.head = head
        self.pad_to_roundup = pad_to_roundup
        in_ch = 1
        for i, ch in enumerate(self.conv_channels):
            self.add_module(f'conv_block{i + 1}',
                            blocks.ConvBlock(in_ch, ch, dtype=compute_dtype))
            in_ch = ch
        if temporal == 'gru':
            self.gru = blocks.BiGRU(in_ch, gru_hidden)
            in_ch = 2 * gru_hidden
        elif temporal == 'multihead':
            self.multihead = blocks.MultiHead(in_ch)
        if head == 'att':
            self.att_block = blocks.AttBlock(in_ch, classes_num,
                                             activation='sigmoid')
        else:
            self.fc = nn.Linear(in_ch, classes_num)

    def forward(self, wav: torch.Tensor,
                mixup_lambda: Optional[torch.Tensor] = None,
                timeshift: bool = False, spec_augment: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        interpolate_ratio = 2 ** (len(self.conv_channels) - 1)
        x = self.compute_features(wav, mixup_lambda, timeshift,
                                  spec_augment, generator)   # (B,1,T,F)
        for i in range(len(self.conv_channels)):
            last = i == len(self.conv_channels) - 1
            x = getattr(self, f'conv_block{i + 1}')(
                x, pool_size=(1, 1) if last else (2, 2), pool_type='avg')
        x = torch.mean(x, dim=3).transpose(1, 2)             # (B,T',C)

        if self.temporal == 'gru':
            x = self.gru(x)
        elif self.temporal == 'multihead':
            x = self.multihead(x, generator)

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
