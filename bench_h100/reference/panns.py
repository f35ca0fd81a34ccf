"""Plain PyTorch reference of PANNs CNN14's head (``Cnn14_DecisionLevelAtt``
of Kong et al., "PANNs", arXiv:1912.10211; ``audioset_tagging_cnn``
``pytorch/models.py``), the part between the conv stack and the attention
head:

    (B, T', C) mean over mel bins -> max over frames t-1, t, t+1 (the
    edges padded with -inf) + mean over frames t-1, t, t+1 (the edges
    padded with zeros that count: an edge divides by 3) -> fc1 -> ReLU

written out with shifted slices, no pooling operator.  Eval mode: the
dropouts around fc1 are identities.  Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _neighbours(x: torch.Tensor, fill: float) -> tuple:
    """(frame t - 1, frame t + 1) of (B, T, C), ``fill`` beyond the
    edges."""
    edge = torch.full_like(x[:, :1], fill)
    return (torch.cat([edge, x[:, :-1]], dim=1),
            torch.cat([x[:, 1:], edge], dim=1))


def smoothing(x: torch.Tensor) -> torch.Tensor:
    """The 3-wide max plus the 3-wide average over frames, (B, T, C)."""
    lo, hi = _neighbours(x, float('-inf'))
    peak = torch.maximum(torch.maximum(lo, x), hi)
    lo, hi = _neighbours(x, 0.0)
    return peak + (lo + x + hi) / 3.0


def head(x: torch.Tensor, p: dict) -> torch.Tensor:
    """(B, T', C) -> (B, T', fc1 width): smoothing, fc1, ReLU."""
    return F.relu(F.linear(smoothing(x), p['fc1.weight'], p['fc1.bias']))
