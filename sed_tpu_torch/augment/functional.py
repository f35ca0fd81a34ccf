"""Train-time augmentation on tensors (counterpart of
``sed_tpu/augment/functional.py``).

Every random augmentation is a *draw* (the random values, from an
explicit ``torch.Generator`` on the tensor's device) and an *apply* that
takes the drawn values, so a test can inject the draws of ``sed_tpu``'s
JAX keys and hold the apply to it bit for bit.

Feature layout: (B, 1, T, F), the port's; ``sed_tpu`` uses (B, T, F, 1).

Distributions (the reference's, ``pytorch/augmentation.py:8-53``,
``pytorch/pytorch_utils.py:81-138``):

* SpecAugment: per sample, 2 time stripes of width U[0, 64) and 2 freq
  stripes of width U[0, 8), each starting at floor(u * (total - width))
  with u ~ U[0, 1) -- zeroed.
* mixup: consecutive pairs mixed with (lam, 1 - lam); halves the batch.
* timeshift: one roll of trunc(N(0, 90)) frames for the whole batch
  (truncated toward zero, not rounded).

Under data parallelism ``sed_tpu`` draws for the global batch.  A
``RowShard`` in place of the generator does the same here: each rank's
per-row draws (SpecAugment's stripes, ``models.blocks.dropout``'s masks)
are made from the same-seeded generator at the global batch size, and
the rank keeps its own rows; a per-batch draw (timeshift) is the same on
every rank.  So every rank's generator advances alike and the ranks
together draw what one process draws for the whole batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

TIME_AXIS, FREQ_AXIS = 2, 3


class RowShard(NamedTuple):
    """A generator shared by ``count`` ranks, each holding rows ``index``
    of ``count`` equal, contiguous shares of the global batch."""
    generator: Optional[torch.Generator]
    index: int
    count: int


def unshard(generator) -> RowShard:
    """``generator`` (a ``torch.Generator``, None or a ``RowShard``) as a
    ``RowShard``; a plain generator is one rank's of one."""
    if isinstance(generator, RowShard):
        return generator
    return RowShard(generator, 0, 1)


def rand_rows(generator, shape, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows (dim 0) of the global
    batch: drawn at ``count`` times the rows, this rank's share kept."""
    gen, k, n = unshard(generator)
    rows = shape[0]
    u = torch.rand((rows * n,) + tuple(shape[1:]), generator=gen,
                   device=device)
    return u[k * rows:(k + 1) * rows] if n > 1 else u


class Stripes(NamedTuple):
    """Drawn stripes of one axis: (B, stripes_num) starts and widths."""
    bgn: torch.Tensor
    dist: torch.Tensor


def draw_stripes(generator, batch: int, total: int, drop_width: int,
                 stripes_num: int, device=None) -> Stripes:
    """Widths U[0, drop_width), starts floor(u * (total - width)), for
    ``batch`` rows (this rank's, of a ``RowShard``'s global batch)."""
    gen, k, n = unshard(generator)
    dist = torch.randint(0, drop_width, (batch * n, stripes_num),
                         generator=gen, device=device)
    u = torch.rand((batch * n, stripes_num), generator=gen, device=device)
    bgn = torch.floor(u * (total - dist)).to(torch.int64)
    rows = slice(k * batch, (k + 1) * batch)
    return Stripes(bgn[rows], dist[rows])


def apply_stripes(x: torch.Tensor, axis: int, stripes: Stripes
                  ) -> torch.Tensor:
    """Zero every position of ``axis`` that a stripe of its sample
    covers (``x * keep``, as ``sed_tpu`` multiplies)."""
    total = x.shape[axis]
    pos = torch.arange(total, device=x.device)
    bgn = stripes.bgn.to(x.device)
    end = bgn + stripes.dist.to(x.device)
    covered = ((pos[None, None, :] >= bgn[:, :, None])
               & (pos[None, None, :] < end[:, :, None]))
    keep = ~covered.any(dim=1)                                  # (B, total)
    shape = [1] * x.dim()
    shape[0] = x.shape[0]
    shape[axis] = total
    return x * keep.reshape(shape).to(x.dtype)


def draw_spec_augment(generator, x: torch.Tensor,
                      time_drop_width: int = 64, time_stripes_num: int = 2,
                      freq_drop_width: int = 8, freq_stripes_num: int = 2
                      ) -> tuple:
    """(time stripes, freq stripes) for a (B, 1, T, F) batch."""
    b = x.shape[0]
    return (draw_stripes(generator, b, x.shape[TIME_AXIS], time_drop_width,
                         time_stripes_num, x.device),
            draw_stripes(generator, b, x.shape[FREQ_AXIS], freq_drop_width,
                         freq_stripes_num, x.device))


def apply_spec_augment(x: torch.Tensor, draws: tuple) -> torch.Tensor:
    time, freq = draws
    return apply_stripes(apply_stripes(x, TIME_AXIS, time), FREQ_AXIS, freq)


def spec_augment(x: torch.Tensor, generator=None) -> torch.Tensor:
    """SpecAugment on a (B, 1, T, F) log-mel batch."""
    return apply_spec_augment(x, draw_spec_augment(generator, x))


def do_mixup(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """out[i] = x[2i] * lam[2i] + x[2i+1] * lam[2i+1]: halves dim 0."""
    lam = lam.to(device=x.device, dtype=x.dtype).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    return x[0::2] * lam[0::2] + x[1::2] * lam[1::2]


def draw_timeshift(generator, device=None, mean: float = 0.0,
                   std: float = 90.0) -> torch.Tensor:
    """trunc(mean + std * N(0, 1)) as an int64 scalar on ``device``: draws
    in (-1, 1) all give 0, a double-width zero bin as in the reference's
    ``int()``.  One draw for the whole (global) batch."""
    z = torch.randn((), generator=unshard(generator).generator,
                    device=device)
    return torch.trunc(mean + std * z).to(torch.int64)


def apply_timeshift(x: torch.Tensor, shift, axis: int = TIME_AXIS
                    ) -> torch.Tensor:
    """``torch.roll(x, shift, axis)`` for a shift that may be a tensor on
    the device (gathered, so the host never waits for it)."""
    total = x.shape[axis]
    idx = torch.remainder(torch.arange(total, device=x.device)
                          - torch.as_tensor(shift, device=x.device), total)
    return x.index_select(axis, idx)


def do_timeshift(x: torch.Tensor, generator=None,
                 axis: int = TIME_AXIS, mean: float = 0.0,
                 std: float = 90.0) -> torch.Tensor:
    """Roll the whole batch along time by trunc(N(mean, std)) frames."""
    return apply_timeshift(x, draw_timeshift(generator, x.device, mean, std),
                           axis)


def do_mixup_timeshift(x: torch.Tensor, lam: torch.Tensor,
                       generator=None,
                       axis: int = TIME_AXIS) -> torch.Tensor:
    """Timeshift, then mixup (``pytorch_utils.py:97-119``)."""
    return do_mixup(do_timeshift(x, generator, axis=axis), lam)


def _gamma(generator, alpha: float, n: int, device) -> torch.Tensor:
    """Gamma(alpha, 1) by Marsaglia and Tsang's squeeze (alpha < 1 through
    Gamma(alpha + 1) * U^(1 / alpha)); torch's own sampler takes no
    generator."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(n, device=device)
    todo = torch.ones(n, dtype=torch.bool, device=device)
    while bool(todo.any()):
        z = torch.randn(n, generator=generator, device=device)
        u = torch.rand(n, generator=generator, device=device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        out = torch.where(todo & ok, d * v, out)
        todo &= ~ok
    if alpha < 1.0:
        u = torch.rand(n, generator=generator, device=device)
        out = out * u ** (1.0 / alpha)
    return out


def mixup_lambda(generator: Optional[torch.Generator], batch_size: int,
                 alpha: float = 1.0, device=None) -> torch.Tensor:
    """Device-side mixup coefficients: beta(alpha, alpha) per pair,
    expanded to (lam, 1 - lam) per consecutive sample pair."""
    n = batch_size // 2
    if alpha == 1.0:                     # beta(1, 1) is U[0, 1)
        lam = torch.rand(n, generator=generator, device=device)
    else:
        ga = _gamma(generator, alpha, n, device)
        lam = ga / (ga + _gamma(generator, alpha, n, device))
    return torch.stack([lam, 1.0 - lam], dim=1).reshape(-1)


class MixupGenerator:
    """Host-side seeded mixup-lambda generator with the reference's exact
    RNG stream (``utils/utilities.py:375-397``: np.RandomState(1234),
    beta per pair)."""

    def __init__(self, mixup_alpha: float = 1.0, random_seed: int = 1234):
        self.mixup_alpha = mixup_alpha
        self.random_state = np.random.RandomState(random_seed)

    def get_lambda(self, batch_size: int) -> np.ndarray:
        lams = []
        for _ in range(0, batch_size, 2):
            lam = self.random_state.beta(self.mixup_alpha, self.mixup_alpha,
                                         1)[0]
            lams.append(lam)
            lams.append(1.0 - lam)
        return np.array(lams)
