"""The joint weak+strong train step and the eval step (counterpart of
``sed_tpu/train/step.py``).

One step does what the reference's loop does per iteration
(``pytorch/main_strong.py:346-406``): forward the weak batch and each
strong batch in training mode (SpecAugment / mixup / timeshift on the
device, BatchNorm on batch statistics, the running statistics updated by
each forward in turn), mix the targets with the same lambdas, sum
``weak_loss + strong_loss``, and take one AMSGrad step.  Every random
draw of the step comes from the ``torch.Generator`` it is given, in the
order weak batch, then each strong batch.

``loss_scale='dynamic'`` scales the loss, unscales the gradients, and
SKIPS a step whose gradients are not all finite: parameters, optimizer
state, step count and the BatchNorm running statistics of that step are
left exactly as they were; the scale halves (not below 1), and doubles
after 200 consecutive finite steps (capped at 2^15).  A float fixes a
static scale with the same skip.

Data parallelism (``group``, a ``torch.distributed`` process group over
the ranks that hold different rows; ``sed_tpu``'s ``mesh``).  Each rank
passes its own equal share of the global batch (mixup pairs kept on one
rank).  The step then equals one process's step on the global batch:
BatchNorm normalises with the global batch's statistics
(``models/blocks.BatchNorm``), every random draw is made for the global
batch and sliced (``augment/functional.RowShard``), and after the single
backward the gradients are averaged over ``group`` by ONE all-reduce of
a flat buffer.  Not ``DistributedDataParallel``: its reducer and
``broadcast_buffers`` assume one forward per backward, where this step
runs one forward for the weak batch and one for each strong batch before
its backward, and a skipped step must leave the BatchNorm buffers as
they were.  The finite flag of a loss-scaled step is agreed over all
ranks (all-reduce MIN) before the skip, so every rank skips or none
does.  ``loss``, ``weak_loss`` and ``strong_loss`` are global means.
Parameters and buffers are broadcast from the group's first rank when
the step is built.  A model whose larger parameters FSDP shards over a
second mesh axis (``parallel/mesh.fsdp_shard``) takes the same step:
FSDP averages over that axis, this step over ``group``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from sed_tpu_torch.augment import functional as aug
from sed_tpu_torch.models.blocks import set_batchnorm_group
from sed_tpu_torch.ops import wire as wire_ops
from sed_tpu_torch.train.state import local


class LossScaleState(NamedTuple):
    """Dynamic loss-scale state: the scale and the consecutive finite
    steps since it last changed."""
    scale: float
    good_steps: int


def init_loss_scale(initial: float = 2.0 ** 12) -> LossScaleState:
    return LossScaleState(scale=float(initial), good_steps=0)


_GROWTH_INTERVAL = 200
_MAX_SCALE = 2.0 ** 15
_MIN_SCALE = 1.0


def _bn_buffers(model: nn.Module) -> list:
    return [b for m in model.modules() if isinstance(m, _BatchNorm)
            for b in m.buffers()]


def _all_finite(tensors, agree: bool = False) -> bool:
    """Whether every tensor is finite; with ``agree``, over every rank of
    the default process group (all-reduce MIN)."""
    flag = torch.stack([torch.isfinite(local(t)).all() for t in tensors]
                       ).all().to(torch.int32) if tensors else \
        torch.ones((), dtype=torch.int32)
    if agree:
        import torch.distributed as dist
        flag = flag.reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.all())


def _group_mean_(tensors, group) -> None:
    """Average ``tensors`` (local shards) over ``group`` in place, by one
    all-reduce of a flat buffer."""
    import torch.distributed as dist
    tensors = [local(t) for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def broadcast_state(model: nn.Module, group) -> None:
    """Parameters and buffers of ``model`` (their local shards) from the
    first rank of ``group`` to the others, so that every rank starts
    from the same state."""
    import torch.distributed as dist
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(local(t), src=src, group=group)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    weak_loss_func: Callable, strong_loss_func: Callable,
                    mixup: bool, timeshift: bool, spec_augment: bool,
                    loss_scale: Optional[Union[str, float]] = None,
                    wire_samples: Optional[int] = None, group=None):
    """Build the joint train step of ``model`` and ``optimizer``.

    Returns ``step(weak_batch, strong_batches, generator) -> metrics``
    (``{'loss', 'weak_loss', 'strong_loss'}``, tensors on the device).
    Batches are dicts of tensors on the model's device: weak
    ``{'waveform', 'target'[, 'mixup_lambda']}``, strong ``{'waveform',
    'strong_target'[, 'mixup_lambda']}``; ``strong_batches`` is one such
    dict or a list (FSD50K adds a second stream).  Waveforms may be any
    wire of ``ops/wire.py``; ``wire_samples`` names the decoded length of
    the narrower-than-samples uint8 wires.

    With ``loss_scale='dynamic'`` the step is ``step(weak_batch,
    strong_batches, generator, scale_state) -> (metrics, scale_state)``
    and metrics gain ``grads_finite`` and ``loss_scale``; a float gives
    the 3-argument signature with those metrics.

    With ``group`` the batches are this rank's shares and the step is
    the data-parallel one of the module docstring: building it sets the
    model's BatchNorm group and broadcasts its state from the group's
    first rank.
    """
    shard = None
    if group is not None:
        import torch.distributed as dist
        set_batchnorm_group(model, group)
        broadcast_state(model, group)
        shard = (dist.get_rank(group), dist.get_world_size(group))

    def _forward(batch, generator):
        lam = batch.get('mixup_lambda') if mixup else None
        wav = wire_ops.dequant_wire(batch['waveform'], wire_samples)
        out = model(wav, mixup_lambda=lam, timeshift=timeshift,
                    spec_augment=spec_augment, generator=generator)
        return out, lam

    def loss_fn(weak_batch, strong_batches, generator):
        out_w, lam_w = _forward(weak_batch, generator)
        target_w = weak_batch['target']
        if lam_w is not None:
            target_w = aug.do_mixup(target_w, lam_w)
        weak_loss = weak_loss_func(out_w, {'target': target_w})

        strong_loss = torch.zeros((), device=weak_loss.device)
        for batch in strong_batches:
            out_s, lam_s = _forward(batch, generator)
            target_s = batch['strong_target']
            if lam_s is not None:
                target_s = aug.do_mixup(target_s, lam_s)
            strong_loss = strong_loss + strong_loss_func(
                out_s, {'strong_target': target_s})
        return weak_loss + strong_loss, weak_loss, strong_loss

    def _backward(weak_batch, strong_batches, generator, scale=None):
        if isinstance(strong_batches, dict):
            strong_batches = [strong_batches]
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if shard is not None:
            generator = aug.RowShard(generator, *shard)
        loss, weak_loss, strong_loss = loss_fn(weak_batch, strong_batches,
                                               generator)
        (loss if scale is None else loss * scale).backward()
        losses = torch.stack([loss, weak_loss, strong_loss]).detach()
        if shard is not None:
            _group_mean_([p.grad for p in _params_with_grad()] + [losses],
                         group)
        return dict(zip(('loss', 'weak_loss', 'strong_loss'), losses))

    def _params_with_grad():
        return [p for g in optimizer.param_groups for p in g['params']
                if p.grad is not None]

    def step(weak_batch, strong_batches, generator):
        metrics = _backward(weak_batch, strong_batches, generator)
        optimizer.step()
        return metrics

    def scaled_step(weak_batch, strong_batches, generator,
                    scale_state: LossScaleState):
        buffers = _bn_buffers(model)
        saved = [b.clone() for b in buffers]
        scale = scale_state.scale
        metrics = _backward(weak_batch, strong_batches, generator, scale)
        grads = [local(p.grad) for p in _params_with_grad()]
        torch._foreach_mul_(grads, 1.0 / scale)
        finite = _all_finite(grads, agree=shard is not None)
        if finite:
            optimizer.step()
        else:
            # the bad batch never happened: parameters, optimizer state
            # and step are untouched, the BatchNorm statistics restored
            optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    b.copy_(s)
        if dynamic:
            good = scale_state.good_steps + 1 if finite else 0
            grow = good >= _GROWTH_INTERVAL
            if not finite:
                scale = max(scale * 0.5, _MIN_SCALE)
            elif grow:
                scale = min(scale * 2.0, _MAX_SCALE)
            scale_state = LossScaleState(scale, 0 if grow else good)
        metrics.update(grads_finite=finite, loss_scale=scale_state.scale)
        return metrics, scale_state

    dynamic = loss_scale == 'dynamic'
    if loss_scale is not None and not dynamic:
        fixed = LossScaleState(float(loss_scale), 0)

        def scaled_step_static(weak_batch, strong_batches, generator):
            return scaled_step(weak_batch, strong_batches, generator,
                               fixed)[0]

        return scaled_step_static
    return scaled_step if dynamic else step


def make_eval_step(model: nn.Module):
    """Eval-mode forward returning the full output dict; the model's
    mode is restored afterwards."""

    @torch.inference_mode()
    def step(waveform: torch.Tensor) -> dict:
        was_training = model.training
        model.eval()
        try:
            return model(wire_ops.dequant_wire(waveform))
        finally:
            model.train(was_training)

    return step
