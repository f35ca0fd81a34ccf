"""The eval-mode epilogue of a ConvBlock convolution in one pass: the
wrapper of the CUDA kernel ``csrc/conv_epilogue.cu``.

``conv_epilogue(x, mean, var, weight, bias, eps, pool)`` takes a
convolution's (B, C, H, W) float32 output and a BatchNorm's running
statistics, weight, bias and eps, and returns ``relu(batch_norm(x))``,
average-pooled by ``pool``, (1, 1) or (2, 2).  A CPU tensor goes to the
plain version, ``conv_epilogue_plain``: ``F.batch_norm`` (eval),
``F.relu`` and ``F.avg_pool2d``, the ops a ConvBlock runs without the
kernel.  A CUDA tensor launches the kernel, or raises: there is no
fallback.  The kernel reads each element once and writes each output
once, where the three ops read and write the whole tensor three times.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sed_tpu_torch import _build
from sed_tpu_torch.utils.profiling import span

POOLS = ((1, 1), (2, 2))
# x, mean, var, weight, bias, eps, out, planes, channels, height, width,
# pool, stream
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_float, ctypes.c_void_p,
                                      ctypes.c_longlong) + \
    (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def conv_epilogue_plain(x: torch.Tensor, mean: torch.Tensor,
                        var: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float,
                        pool=(1, 1)) -> torch.Tensor:
    """``F.avg_pool2d(F.relu(F.batch_norm(x, ...)), pool)`` in eval mode,
    the pool left out at (1, 1)."""
    x = F.relu(F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps))
    return x if tuple(pool) == (1, 1) else F.avg_pool2d(x, pool)


def conv_epilogue(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor, eps: float,
                  pool=(1, 1)) -> torch.Tensor:
    """(B, C, H, W) -> relu(batch_norm(x)) average-pooled by ``pool``:
    (B, C, H, W) at (1, 1), (B, C, H // 2, W // 2) at (2, 2).  The CUDA
    kernel for a CUDA tensor, in a ``sed::conv.epilogue`` span,
    ``conv_epilogue_plain`` for a CPU tensor.

    The kernel takes a contiguous float32 ``x`` and float32 (C,)
    statistics on its device.  It has no backward, and a ctypes call is
    invisible to autograd, so a CUDA input that would want a gradient
    raises instead of coming back silently detached.
    ``conv_epilogue.launches`` counts kernel launches."""
    pool = tuple(pool)
    if pool not in POOLS:
        raise ValueError(f'conv_epilogue pools by (1, 1) or (2, 2), not '
                         f'{pool}')
    if x.device.type == 'cpu':
        return conv_epilogue_plain(x, mean, var, weight, bias, eps, pool)
    with span('conv.epilogue'):
        return _launch(x, mean, var, weight, bias, eps, pool)


def _launch(x, mean, var, weight, bias, eps, pool) -> torch.Tensor:
    """``conv_epilogue``'s kernel on a card tensor, or a ValueError."""
    if x.device.type != 'cuda':
        raise ValueError(f'conv_epilogue: unsupported device {x.device}')
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f'conv_epilogue wants a contiguous (B, C, H, W) '
                         f'float32 tensor, got {tuple(x.shape)} {x.dtype}'
                         f'{"" if x.is_contiguous() else " (strided)"}')
    b, c, h, w = x.shape
    for name, t in (('mean', mean), ('var', var), ('weight', weight),
                    ('bias', bias)):
        if t.dtype != torch.float32 or t.shape != (c,) or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f'conv_epilogue wants a contiguous ({c},) '
                             f'float32 {name} on {x.device} for {c} '
                             f'channels, got {tuple(t.shape)} {t.dtype} on '
                             f'{t.device}')
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise ValueError('conv_epilogue has no backward: the CUDA kernel '
                         'would cut the graph of a tensor that requires '
                         'grad')
    if h * w >= 2 ** 31 or (pool == (2, 2) and (h < 2 or w < 2)):
        raise ValueError(f'conv_epilogue takes planes of under 2^31 floats, '
                         f'at least 2 x 2 to pool; got {h} x {w} at {pool}')
    out = torch.empty((b, c, h // pool[0], w // pool[1]),
                      dtype=torch.float32, device=x.device)
    if out.numel():
        _build.launch('conv_epilogue', _ARGTYPES, x.device, x.data_ptr(),
                      mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
                      bias.data_ptr(), eps, out.data_ptr(), b * c, c, h, w,
                      pool[0])
        conv_epilogue.launches += 1
    return out


conv_epilogue.launches = 0
