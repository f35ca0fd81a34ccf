"""Loss functions (counterpart of ``sed_tpu/losses.py``).

The BCE computes ``F.binary_cross_entropy``, the function whose numerics
``sed_tpu``'s ``custom_vjp`` imitates: log terms clamped at -100, so
exact 0/1 probabilities give finite losses, and the backward denominator
p (1 - p) clamped at 1e-12, so saturated sigmoids give finite gradients.
It is written out as an autograd Function because torch's own kernel
checks that every probability lies in [0, 1]: a NaN from a bad batch is
an error on the CPU and a device-side assert on the GPU, which ends the
process, where the reference's loss goes NaN and the loss-scaled step
skips the batch.
"""

from __future__ import annotations

import torch


class _BceElements(torch.autograd.Function):
    """Elementwise BCE with torch's clamps (``sed_tpu/losses.py:13-37``)."""

    @staticmethod
    def forward(ctx, p, t):
        ctx.save_for_backward(p, t)
        logp = torch.clamp_min(torch.log(p), -100.0)
        log1p = torch.clamp_min(torch.log1p(-p), -100.0)
        return -(t * logp + (1.0 - t) * log1p)

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        dp = g * (p - t) / torch.clamp_min(p * (1.0 - p), 1e-12)
        dt = None
        if ctx.needs_input_grad[1]:
            dt = g * (torch.clamp_min(torch.log1p(-p), -100.0)
                      - torch.clamp_min(torch.log(p), -100.0))
        return dp, dt


def _bce(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.mean(_BceElements.apply(p, t.to(p.dtype)))


def _bce_logits(logits: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # the numerically stable BCE-with-logits, written as sed_tpu writes it
    return torch.mean(torch.clamp_min(logits, 0) - logits * t
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def clip_bce(output_dict: dict, target_dict: dict) -> torch.Tensor:
    return _bce(output_dict['clipwise_output'], target_dict['target'])


def clip_bce_logits(output_dict: dict, target_dict: dict) -> torch.Tensor:
    return _bce_logits(output_dict['clipwise_output'], target_dict['target'])


def _truncate_to_min_t(output: torch.Tensor, target: torch.Tensor):
    n = min(output.shape[1], target.shape[1])
    return output[:, :n, :], target[:, :n, :]


def frame_bce(output_dict: dict, target_dict: dict) -> torch.Tensor:
    """Strong framewise BCE; output and target truncated to the common
    number of frames (``pytorch/losses.py:16-28``)."""
    output, target = _truncate_to_min_t(output_dict['framewise_output'],
                                        target_dict['strong_target'])
    return _bce(output, target)


def frame_bce_logits(output_dict: dict, target_dict: dict) -> torch.Tensor:
    output, target = _truncate_to_min_t(output_dict['framewise_output'],
                                        target_dict['strong_target'])
    return _bce_logits(output, target)


LOSS_REGISTRY = {
    'clip_bce': clip_bce,
    'clip_bce_logits': clip_bce_logits,
    'frame_bce': frame_bce,
    'frame_bce_logits': frame_bce_logits,
}


def get_loss_func(loss_type: str):
    return LOSS_REGISTRY[loss_type]
