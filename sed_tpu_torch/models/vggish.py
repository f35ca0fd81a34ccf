"""VGGish transfer-learning backbone + SED heads (counterpart of
``sed_tpu/models/vggish.py``).

The conv stack is torch-vggish's with its fc layers stripped: [64] pool
[128] pool [256 x 2] pool [512 x 2] pool, 3x3 convs with bias + ReLU,
2x2 max pools (floor).  Head notes, as in the reference's forwards:

* every VGGish head skips ``bn0`` (commented out upstream): the model
  has no ``bn0`` tensors;
* 'att': interpolate x12, then pad to 1000 frames whatever the clip;
* 'gru_att': BiGRU(512 -> 256 x 2) before the attention head;
* 'avg': the ratio is 1000 // T'.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.base import SedFeatureBase

_PLAN = ((64,), (128,), (256, 256), (512, 512))


class VGGishFeatures(nn.Module):
    """The VGGish conv stack, (B, 1, T, F) -> (B, 512, T // 16, F // 16);
    ``conv0``..``conv5`` as in the flax tree."""

    def __init__(self):
        super().__init__()
        in_ch, idx = 1, 0
        for stage in _PLAN:
            for ch in stage:
                self.add_module(f'conv{idx}',
                                nn.Conv2d(in_ch, ch, 3, padding=1))
                in_ch, idx = ch, idx + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idx = 0
        for stage in _PLAN:
            for _ in stage:
                x = F.relu(getattr(self, f'conv{idx}')(x))
                idx += 1
            x = F.max_pool2d(x, 2)
        return x


class VGGishSed(SedFeatureBase):
    """VGGish features + {att, gru_att, avg} head."""

    reference_unused = ('bn0',)

    def __init__(self, cfg, classes_num: int = 25,
                 feature_type: str = 'logmel', head: str = 'att',
                 gru_hidden: int = 256, compute_dtype=None):
        super().__init__(cfg, feature_type, skip_bn0=True,
                         compute_dtype=compute_dtype)
        if head not in ('att', 'gru_att', 'avg'):
            raise ValueError(f'unknown head: {head}')
        self.head = head
        self.vggish = VGGishFeatures()
        in_ch = 512
        if head == 'gru_att':
            self.gru = blocks.BiGRU(in_ch, gru_hidden)
            in_ch = 2 * gru_hidden
        if head == 'avg':
            self.fc = nn.Linear(in_ch, classes_num)
        else:
            self.att_block = blocks.AttBlock(in_ch, classes_num,
                                             activation='sigmoid')

    def forward(self, wav: torch.Tensor,
                mixup_lambda: Optional[torch.Tensor] = None,
                timeshift: bool = False, spec_augment: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        x = self.compute_features(wav, mixup_lambda, timeshift,
                                  spec_augment, generator)
        x = torch.mean(self.vggish(x), dim=3).transpose(1, 2)  # (B,T',512)
        if self.head == 'gru_att':
            x = self.gru(x)

        if self.head == 'avg':
            framewise = torch.sigmoid(self.fc(x))
            framewise = blocks.interpolate(
                framewise, max(1, 1000 // framewise.shape[1]))
            embedding = x
        else:
            clipwise, _, cla = self.att_block(x)
            framewise = blocks.interpolate(cla, 12)
            embedding = cla
        if framewise.shape[1] < 1000:
            framewise = blocks.pad_framewise_output(framewise, 1000)
        if self.head == 'avg':
            clipwise = torch.mean(framewise, dim=1)

        return {'framewise_output': framewise,
                'clipwise_output': clipwise,
                'embedding': embedding}
