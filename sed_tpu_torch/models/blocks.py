"""Shared model building blocks (counterpart of
``sed_tpu/models/blocks.py``).

Convolutions run channels-first, (B, C, T, F), as PyTorch prefers; the
GRU and attention head take the JAX layout (B, T, C).  The BiGRU is
``nn.GRU``, whose gate layout (r, z, n) and ``n = tanh(W_in x + b_in +
r * (W_hn h + b_hn))`` are what ``sed_tpu`` stores and computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def roundup(x: int) -> int:
    """Next multiple of 100."""
    return x if x % 100 == 0 else x + 100 - x % 100


def interpolate(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Nearest-repeat upsample along time: (B, T, C) -> (B, T*ratio, C)."""
    return torch.repeat_interleave(x, ratio, dim=1)


def pad_framewise_output(x: torch.Tensor, frames_num: int) -> torch.Tensor:
    """Pad (B, T, C) to ``frames_num`` frames by repeating the last one."""
    pad = x[:, -1:, :].expand(-1, frames_num - x.shape[1], -1)
    return torch.cat([x, pad], dim=1)


class ConvBlock(nn.Module):
    """[Conv3x3 (no bias) -> BN -> ReLU] x2, then avg/max/avg+max pool.
    (B, C_in, T, F) -> (B, C_out, T', F')."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, pool_size=(2, 2),
                pool_type: str = 'avg') -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        if tuple(pool_size) == (1, 1):
            return x
        if pool_type == 'avg':
            return F.avg_pool2d(x, pool_size)
        if pool_type == 'max':
            return F.max_pool2d(x, pool_size)
        if pool_type == 'avg+max':
            return F.avg_pool2d(x, pool_size) + F.max_pool2d(x, pool_size)
        raise ValueError(f'Incorrect pool_type: {pool_type}')


class AttBlock(nn.Module):
    """Attention pooling head over (B, T, C_in).  Returns (clipwise
    (B, n_out), norm_att (B, T, n_out), cla (B, T, n_out))."""

    def __init__(self, n_in: int, n_out: int, activation: str = 'linear',
                 temperature: float = 1.0):
        super().__init__()
        self.att = nn.Linear(n_in, n_out)
        self.cla = nn.Linear(n_in, n_out)
        self.activation = activation
        self.temperature = temperature

    def forward(self, x: torch.Tensor):
        att = torch.clamp(self.att(x), -10.0, 10.0)
        att = torch.exp(att / self.temperature) + 1e-6
        norm_att = att / torch.sum(att, dim=1, keepdim=True)
        cla = self.cla(x)
        if self.activation == 'sigmoid':
            cla = torch.sigmoid(cla)
        clipwise = torch.sum(norm_att * cla, dim=1)
        return clipwise, norm_att, cla


class BiGRU(nn.GRU):
    """Bidirectional single-layer GRU, (B, T, D) -> (B, T, 2H); the
    backward direction's outputs are aligned to input time, as in
    ``sed_tpu``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]
