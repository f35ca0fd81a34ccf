"""Shared model building blocks (counterpart of
``sed_tpu/models/blocks.py``).

Convolutions run channels-first, (B, C, T, F), as PyTorch prefers; the
GRU and attention head take the JAX layout (B, T, C).  The BiGRU is
``nn.GRU``, whose gate layout (r, z, n) and ``n = tanh(W_in x + b_in +
r * (W_hn h + b_hn))`` are what ``sed_tpu`` stores and computes.
``MultiHead`` is the reference's one-block self-attention.

``BatchNorm`` keeps flax's running statistics in training mode (over
the global batch of a process group when it has one), ``ConvBlock``
takes ``sed_tpu``'s bf16 compute dtype and, in eval mode on the card,
runs each convolution's BatchNorm, ReLU and pool as one kernel
(``epilogue``), and ``init_weights`` draws a fresh model from
``sed_tpu``'s initialisers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from sed_tpu_torch.augment.functional import rand_rows
from sed_tpu_torch.ops import conv_epilogue
from sed_tpu_torch.utils.profiling import span


class BatchNorm(_BatchNorm):
    """BatchNorm over dim 1 of (B, C, ...), for ``bn0`` and the ConvBlocks.

    Eval mode is ``nn.BatchNorm``'s.  In training mode the output is
    normalised with the batch mean and biased variance, as
    ``nn.BatchNorm`` does, but the running variance moves toward the
    *biased* batch variance, as flax's does; torch's moves toward the
    unbiased one, n / (n - 1) larger.  Momentum 0.1 here is flax's 0.9:
    ``running = 0.9 running + 0.1 batch``.

    With ``process_group`` set (``set_batchnorm_group``), training mode
    normalises with the statistics of the group's global batch, as
    ``sed_tpu``'s BatchNorm over a sharded array does: per channel, the
    sum, the sum of squares (both summed in float64) and the count are
    all-reduced over the group, and the mean and biased variance of the
    whole batch normalise this rank's rows and move the running
    statistics.  The all-reduce is differentiable, so the backward sees
    the global statistics too.  ``nn.SyncBatchNorm`` would move the
    running variance toward the unbiased one.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.process_group = None

    def _check_input_dim(self, input: torch.Tensor) -> None:
        if input.dim() < 2:
            raise ValueError(f'expected (B, C, ...), got {input.dim()}D')

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        if self.process_group is not None:
            out, mean, var = self._global_batch_norm(x, dims)
        else:
            out = F.batch_norm(x, None, None, self.weight, self.bias, True,
                               0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=dims, correction=0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return out

    def _global_batch_norm(self, x: torch.Tensor, dims: list) -> tuple:
        """(output, global mean, global biased variance) over the
        process group's batch."""
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c, dtype=torch.float64)
        stats = _AllReduceSum.apply(torch.cat([
            x.sum(dims, dtype=torch.float64),
            (x * x).sum(dims, dtype=torch.float64), count]),
            self.process_group)
        mean = stats[:c] / stats[2 * c]
        var = (stats[c:2 * c] / stats[2 * c] - mean * mean).clamp_min(0.0)
        shape = [1, c] + [1] * (x.dim() - 2)
        scale = self.weight * torch.rsqrt(var + self.eps).to(x.dtype)
        out = (x - mean.to(x.dtype).view(shape)) * scale.view(shape) \
            + self.bias.view(shape)
        return out, mean.detach().to(x.dtype), var.detach().to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; each rank's input gradient is the sum of
    every rank's output gradient.  (``torch.distributed.nn.functional.
    all_reduce`` does the same and is deprecated; its replacement in
    ``_functional_collectives`` has no backward.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        import torch.distributed as dist
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def set_batchnorm_group(model: nn.Module, group) -> nn.Module:
    """Give every ``BatchNorm`` of ``model`` the process group whose
    global batch its training-mode statistics span (None: this
    process's batch alone)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    return model


def dropout(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate (a uniform draw
    below it, from ``generator``), kept values scaled by 1 / (1 - rate).
    Dim 0 is the batch: a ``RowShard`` generator draws the mask of the
    global batch and keeps this rank's rows."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = rand_rows(generator, x.shape, x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


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


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


class measured_choice:
    """``with measured_choice():`` runs the block with cuDNN in benchmark
    mode: a convolution whose (shape, dtype, layout) the process has not
    run before times cuDNN's candidate engines (``benchmark_limit`` of
    them) and keeps the fastest for the process.  One it has run, in
    either mode, keeps the plan it has: torch's plan cache does not key
    on the flag.  Only the benchmark flag changes, and it is as it was
    when the block leaves, also on an exception
    (``torch.backends.cudnn.flags`` would reset every flag it is not
    given, the fp32 precision among them)."""

    __slots__ = ('_saved',)

    def __enter__(self) -> 'measured_choice':
        self._saved = torch._C._get_cudnn_benchmark()
        torch._C._set_cudnn_benchmark(True)
        return self

    def __exit__(self, *exc) -> bool:
        torch._C._set_cudnn_benchmark(self._saved)
        return False


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` when it is set:
    input and weight rounded to it, the output (rounded to it too, as
    ``sed_tpu``'s ``nn.Conv(dtype=bfloat16)`` returns it) cast back to
    float32.  The weight, its gradient's destination and the optimizer
    state stay float32.  The cast is inside ``forward``, so hooks on the
    module (FSDP's all-gather) see the call.

    In eval mode on the card the convolution runs under
    ``measured_choice``: for one layer of the 5 s conv stack (128
    channels at 250 x 32) cuDNN's heuristic picks an FFT convolution
    nine times slower than the implicit GEMM that timing picks.  Training
    mode and CPU tensors run as ``nn.Conv2d`` does.  Counters:
    ``measured_calls``, the convolutions run so; ``searched_shapes``,
    those whose shape (input, weight, compute dtype, device) the process
    had not run so before, each inside a ``sed::conv.search`` span."""

    measured_calls = 0
    searched_shapes = 0
    _searched = set()

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        # what, besides the input and the compute dtype, keys a plan
        self._geometry = (tuple(self.weight.shape), self.stride,
                          self.padding, self.dilation, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or not _on_card(x):
            return self._compute(x)
        key = (x.shape, x.dtype, x.device, self.compute_dtype,
               self._geometry)
        Conv2d.measured_calls += 1
        with measured_choice():
            if key in Conv2d._searched:
                return self._compute(x)
            with span('conv.search'):
                out = self._compute(x)
        Conv2d._searched.add(key)
        Conv2d.searched_shapes += 1
        return out

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  bias).to(x.dtype)


class ConvBlock(nn.Module):
    """[Conv3x3 (no bias) -> BN -> ReLU] x2, then avg/max/avg+max pool.
    (B, C_in, T, F) -> (B, C_out, T', F').

    ``dtype`` (e.g. ``torch.bfloat16``) is the convolutions' compute
    dtype (``sed_tpu/models/blocks.py:65-72``); BatchNorm, ReLU and the
    pooling stay float32.  Not ``torch.autocast``: that would also cast
    the linear layers, GRU and attention products after the stack, which
    ``sed_tpu`` keeps in float32.

    Each convolution's BatchNorm and ReLU run as one ``epilogue``; a
    (2, 2) 'avg' pool runs in the second's."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1,
                            bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, pool_size=(2, 2),
                pool_type: str = 'avg') -> torch.Tensor:
        pool_size = tuple(pool_size)
        x = epilogue(self.conv1(x), self.bn1)
        if pool_size == (1, 1) or (pool_size == (2, 2)
                                   and pool_type == 'avg'):
            return epilogue(self.conv2(x), self.bn2, pool_size)
        x = epilogue(self.conv2(x), self.bn2)
        if pool_type == 'avg':
            return F.avg_pool2d(x, pool_size)
        if pool_type == 'max':
            return F.max_pool2d(x, pool_size)
        if pool_type == 'avg+max':
            return F.avg_pool2d(x, pool_size) + F.max_pool2d(x, pool_size)
        raise ValueError(f'Incorrect pool_type: {pool_type}')


def epilogue(x: torch.Tensor, bn: BatchNorm, pool=(1, 1)) -> torch.Tensor:
    """``relu(bn(x))``, average-pooled by ``pool`` ((1, 1) or (2, 2)).

    Training mode (batch statistics) and autograd (a gradient wanted for
    ``x`` or ``bn``'s affine parameters) run ``bn``, ``F.relu`` and
    ``F.avg_pool2d``.  Otherwise ``ops/conv_epilogue.conv_epilogue`` runs
    it: the same ops on a CPU tensor, one launch of its kernel (in a
    ``sed::conv.epilogue`` span) on a card tensor, and a ValueError for a
    card tensor the kernel does not take."""
    if bn.training or (torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, bn.weight, bn.bias))):
        x = F.relu(bn(x))
        return x if pool == (1, 1) else F.avg_pool2d(x, pool)
    return conv_epilogue.conv_epilogue(x, bn.running_mean, bn.running_var,
                                       bn.weight, bn.bias, bn.eps, pool)


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


class MultiHead(nn.Module):
    """The reference's single self-attention block, (B, T, d_model) ->
    (B, T, d_model): QKV projections, softmax(q k^T / sqrt(d_k)) v over
    8 heads of d_k = d_v = 64, output projection, ReLU.

    Reference quirk kept (``sed_tpu/models/blocks.py:241-279``): no
    residual connection and no layer norm.  In training mode dropout
    ``attn_dropout_rate`` hits the attention weights and ``dropout_rate``
    the output projection, with masks from the caller's generator.  The
    attention is plain fp32 ``matmul`` and ``softmax``, as ``sed_tpu``'s
    einsum; not ``F.scaled_dot_product_attention``, whose CUDA backend is
    picked at run time and sums in another order.
    """

    n_head, d_k, d_v = 8, 64, 64

    def __init__(self, d_model: int, dropout_rate: float = 0.2,
                 attn_dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.w_qs = nn.Linear(d_model, self.n_head * self.d_k)
        self.w_ks = nn.Linear(d_model, self.n_head * self.d_k)
        self.w_vs = nn.Linear(d_model, self.n_head * self.d_v)
        self.fc = nn.Linear(self.n_head * self.d_v, d_model)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        b, t, _ = x.shape
        nh, dk, dv = self.n_head, self.d_k, self.d_v
        q = self.w_qs(x).view(b, t, nh, dk).transpose(1, 2)   # (B,H,T,dk)
        k = self.w_ks(x).view(b, t, nh, dk).transpose(1, 2)
        v = self.w_vs(x).view(b, t, nh, dv).transpose(1, 2)
        attn = torch.softmax(
            torch.matmul(q, k.transpose(2, 3)) / math.sqrt(dk), dim=-1)
        if self.training:
            attn = dropout(attn, self.attn_dropout_rate, generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, nh * dv)
        out = self.fc(out)
        if self.training:
            out = dropout(out, self.dropout_rate, generator)
        return F.relu(out)


# ---------------------------------------------------------------------------
# fresh initialisation (``sed_tpu``'s initialisers)
# ---------------------------------------------------------------------------


# flax's truncated normal: cut at +-2 standard deviations and rescaled
# to keep the variance
_TRUNC_STD = .87962566103423978


def _xavier_normal_(w: torch.Tensor, generator) -> None:
    """flax ``xavier_normal``: variance_scaling(1, fan_avg,
    'truncated_normal'), a normal truncated at two standard deviations
    whose scale is raised to keep the variance 2 / (fan_in + fan_out)."""
    fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(w)
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _init_gru(gru: nn.GRU, generator) -> None:
    """Per gate: W_ih uniform(+-sqrt(3 / D)); W_hh's r and z rows
    uniform(+-sqrt(3 / H)), its n rows orthogonal; biases 0
    (``sed_tpu/models/blocks.py:116-132``)."""
    h = gru.hidden_size
    for suffix in ('_l0', '_l0_reverse'):
        w_ih = getattr(gru, 'weight_ih' + suffix)
        w_hh = getattr(gru, 'weight_hh' + suffix)
        bound = np.sqrt(3.0 / w_ih.shape[1])
        nn.init.uniform_(w_ih, -bound, bound, generator=generator)
        bound = np.sqrt(3.0 / h)
        nn.init.uniform_(w_hh[:2 * h], -bound, bound, generator=generator)
        nn.init.orthogonal_(w_hh[2 * h:], generator=generator)
        nn.init.zeros_(getattr(gru, 'bias_ih' + suffix))
        nn.init.zeros_(getattr(gru, 'bias_hh' + suffix))


def _lecun_normal_(w: torch.Tensor, generator) -> None:
    """flax's default kernel initialiser: variance_scaling(1, fan_in,
    'truncated_normal'), variance 1 / fan_in."""
    fan_in, _ = nn.init._calculate_fan_in_and_fan_out(w)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


# the modules whose kernels ``sed_tpu`` names xavier-uniform: all of a
# ConvBlock's and an AttBlock's, and these heads of a model
_XAVIER_HEADS = ('fc', 'fc1')


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator = None
                 ) -> nn.Module:
    """Draw a fresh model from ``sed_tpu``'s distributions.

    Xavier-uniform where ``sed_tpu`` names it: ConvBlock convs, ``att``,
    ``cla``, the ``fc`` / ``fc1`` heads.  The GRU's per-gate uniform and
    orthogonal n gate.  MultiHead: normal(sqrt(2 / (d_model + d_k))) Q,
    K, V and a xavier-normal ``fc``.  Every other ``Linear`` / ``Conv``
    (the encoder layers, ``linear_emb``, ``classifier``, the VGGish and
    baseline-CNN convs, the depthwise conv) gets flax's default,
    lecun-normal.  Biases, ``r_w_bias`` and ``r_r_bias`` 0; BatchNorm
    and LayerNorm scale 1, bias 0; running mean 0 and variance 1."""
    in_multihead = {id(sub) for mh in model.modules()
                    if isinstance(mh, MultiHead) for sub in mh.modules()}
    xavier = {id(sub) for m in model.modules()
              if isinstance(m, (ConvBlock, AttBlock)) for sub in m.modules()}
    xavier.update(id(getattr(model, name)) for name in _XAVIER_HEADS
                  if hasattr(model, name))
    for name, p in model.named_parameters():
        if name.endswith(('r_w_bias', 'r_r_bias')):
            nn.init.zeros_(p)
    for m in model.modules():
        if isinstance(m, (BatchNorm, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, nn.GRU):
            _init_gru(m, generator)
        elif isinstance(m, MultiHead):
            d_model = m.w_qs.in_features
            for lin, d in ((m.w_qs, m.d_k), (m.w_ks, m.d_k), (m.w_vs, m.d_v)):
                nn.init.normal_(lin.weight, 0.0,
                                float(np.sqrt(2.0 / (d_model + d))),
                                generator=generator)
                nn.init.zeros_(lin.bias)
            _xavier_normal_(m.fc.weight, generator)
            nn.init.zeros_(m.fc.bias)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)) and \
                id(m) not in in_multihead:
            if id(m) in xavier:
                nn.init.xavier_uniform_(m.weight, generator=generator)
            else:
                _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return model
