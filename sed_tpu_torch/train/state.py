"""Train state: model + AMSGrad optimizer (counterpart of
``sed_tpu/train/state.py``).

``sed_tpu`` optimizes with ``optax.amsgrad(lr, b1=0.9, b2=0.999,
eps=1e-8)``.  ``torch.optim.Adam(amsgrad=True)`` is not that function:
torch keeps the running maximum of the *raw* second moment and
bias-corrects it afterwards, optax keeps the maximum of the
*bias-corrected* moment.  The two agree on step 1 and part as soon as a
gradient shrinks (the corrected moment of a later step can fall below
an earlier one's while the raw moment does not).  ``AmsGrad`` below is
optax's form, elementwise:

    mu     = b1 mu + (1 - b1) g
    nu     = b2 nu + (1 - b2) g^2
    nu_max = max(nu_max, nu / (1 - b2^t))
    p     -= lr (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)

Every operation is elementwise, so a parameter that FSDP shards (a
``DTensor``) is updated through its local shard, with its state sharded
alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn


def local(t: torch.Tensor) -> torch.Tensor:
    """The tensor this process holds: a ``DTensor``'s local shard (same
    storage), any other tensor itself."""
    return t.to_local() if hasattr(t, 'to_local') else t


class AmsGrad(torch.optim.Optimizer):
    """``optax.amsgrad`` (``scale_by_amsgrad`` then ``-lr``) as a torch
    optimizer.  The state of each parameter, ``step``, ``mu``, ``nu``
    and ``nu_max``, is in ``state_dict()``.  The bias corrections are
    computed in float32, as optax computes them."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple = (0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    @property
    def steps(self) -> int:
        """Updates taken (0 before the first)."""
        for group in self.param_groups:
            for p in group['params']:
                if self.state.get(p):
                    return int(self.state[p]['step'])
        return 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group['betas']
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p] = {'step': 0,
                                     'mu': torch.zeros_like(p),
                                     'nu': torch.zeros_like(p),
                                     'nu_max': torch.zeros_like(p)}
                self.state[p]['step'] += 1
            t = self.state[params[0]]['step']
            grads = [local(p.grad) for p in params]
            mus = [local(self.state[p]['mu']) for p in params]
            nus = [local(self.state[p]['nu']) for p in params]
            maxs = [local(self.state[p]['nu_max']) for p in params]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            one = np.float32(1.0)
            bc1 = float(one - np.float32(b1) ** np.float32(t))
            bc2 = float(one - np.float32(b2) ** np.float32(t))
            torch._foreach_maximum_(maxs, torch._foreach_div(nus, bc2))
            denom = torch._foreach_sqrt(maxs)
            torch._foreach_add_(denom, group['eps'])
            upd = torch._foreach_div(mus, bc1)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_([local(p) for p in params], upd,
                                alpha=-group['lr'])
        return loss


def make_optimizer(model: nn.Module, learning_rate: float = 1e-3) -> AmsGrad:
    return AmsGrad(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                   eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm buffers), its optimizer,
    and the step count, which is the optimizer's."""
    model: nn.Module
    optimizer: AmsGrad

    @property
    def step(self) -> int:
        return self.optimizer.steps


def create_train_state(model: nn.Module, learning_rate: float = 1e-3,
                       generator: Optional[torch.Generator] = None,
                       fresh: bool = True) -> TrainState:
    """Draw a fresh model (``models.blocks.init_weights``) unless
    ``fresh`` is False, and build its optimizer.  The model's device is
    the optimizer state's."""
    from sed_tpu_torch.models.blocks import init_weights
    if fresh:
        init_weights(model, generator)
    return TrainState(model, make_optimizer(model, learning_rate))
