"""Encoder library: ESPnet-style Transformer and Conformer blocks and
the DCASE baseline CNN (counterpart of ``sed_tpu/models/encoders.py``).

Sequence modules take and return (B, T, D); the convolutional ones run
channels-first, (B, C, T, F), as the rest of the port.  Submodule names
follow the flax parameter tree (``input_layer/linear``, ``block0/mhsa/
qkv_net``, ``layer0/self_attn/linear_q``, ``cnn/conv0`` ...), so
``compat/from_flax.py`` maps a checkpoint leaf by leaf.

Attention is plain fp32 ``matmul`` and ``softmax``, as ``sed_tpu``'s
einsums and for the reason ``blocks.MultiHead`` gives.  Every dropout
acts in training mode only, draws from the ``generator`` the caller
passes, and has its rate as a module attribute.

Numerics against flax: ``nn.LayerNorm`` computes the variance as
E[(x - E[x])^2], flax as E[x^2] - E[x]^2; on unit-scale activations the
two differ by a few float32 ulps per layer (the parity tests state the
tolerance).  The ESPnet layers use eps 1e-12, which float32 cannot tell
from 0; the Conformer's use 1e-5.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sed_tpu_torch.models.blocks import BatchNorm, dropout
from sed_tpu_torch.utils.profiling import span

MIN_VALUE = float(np.finfo(np.float32).min)


def subsequent_mask(size: int) -> np.ndarray:
    """Lower-triangular causal mask."""
    return np.tril(np.ones((size, size), dtype=bool))


def make_non_pad_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """(B, T) True where t < lengths[b]: the attention padding mask."""
    return np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos positional table, (max_len, d_model) float32."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def _constant(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A cached table on ``device``.  Made outside inference mode, so that
    a table first asked for by a serving forward can later be saved for a
    training step's backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(table).to(device)


@functools.lru_cache(maxsize=32)
def _pe(length: int, d_model: int, device: torch.device) -> torch.Tensor:
    return _constant(sinusoidal_table(length, d_model), device)


@functools.lru_cache(maxsize=32)
def _rel_pos(length: int, d_model: int, device: torch.device
             ) -> torch.Tensor:
    """Relative-position embeddings for pos_seq = length-1 .. 0: [sin |
    cos] concatenated (not interleaved), (length, d_model) float32, made
    on the host so that every device gets the same table."""
    pos_seq = np.arange(length - 1, -1, -1, dtype=np.float32)
    inv_freq = (1.0 / (10000.0 ** (np.arange(0, d_model, 2) / d_model))
                ).astype(np.float32)
    sinusoid = pos_seq[:, None] * inv_freq[None]
    table = np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)
    return _constant(table.astype(np.float32), device)


class PositionalEncoding(nn.Module):
    """x * sqrt(d) + PE, then dropout."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = x * math.sqrt(self.d_model) + _pe(x.shape[1], self.d_model,
                                              x.device)[None]
        if self.training:
            x = dropout(x, self.dropout_rate, generator)
        return x


class MultiHeadedAttention(nn.Module):
    """Standard MHA with biasful projections (ESPnet layout).  ``mask``
    is (B, 1 | q, k) bool, True where a key may be attended."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.n_feat = n_feat
        self.dropout_rate = dropout_rate
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def forward(self, query, key, value, mask=None, generator=None):
        b = query.shape[0]
        h, d_k = self.n_head, self.n_feat // self.n_head
        q = self.linear_q(query).view(b, -1, h, d_k).transpose(1, 2)
        k = self.linear_k(key).view(b, -1, h, d_k).transpose(1, 2)
        v = self.linear_v(value).view(b, -1, h, d_k).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(2, 3)) / math.sqrt(d_k)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None], MIN_VALUE)
        attn = torch.softmax(scores, dim=-1)
        if self.training:
            attn = dropout(attn, self.dropout_rate, generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, -1,
                                                            self.n_feat)
        return self.linear_out(out)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.w_1 = nn.Linear(d_model, d_ff)
        self.w_2 = nn.Linear(d_ff, d_model)

    def forward(self, x, generator=None):
        x = F.relu(self.w_1(x))
        if self.training:
            x = dropout(x, self.dropout_rate, generator)
        return self.w_2(x)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN self-attention + FFN; ``after_conv`` max-pools time by 2
    afterwards (and the mask with ``mask[:, ::2, ::2]``)."""

    def __init__(self, adim: int, aheads: int, eunits: int,
                 dropout_rate: float = 0.1, attn_dropout_rate: float = 0.0,
                 after_conv: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.after_conv = after_conv
        self.norm1 = nn.LayerNorm(adim, eps=1e-12)
        self.self_attn = MultiHeadedAttention(aheads, adim,
                                              attn_dropout_rate)
        self.norm2 = nn.LayerNorm(adim, eps=1e-12)
        self.feed_forward = PositionwiseFeedForward(adim, eunits,
                                                    dropout_rate)

    def forward(self, x, mask=None, generator=None):
        nx = self.norm1(x)
        attn = self.self_attn(nx, nx, nx, mask, generator)
        if self.training:
            attn = dropout(attn, self.dropout_rate, generator)
        x = x + attn
        ff = self.feed_forward(self.norm2(x), generator)
        if self.training:
            ff = dropout(ff, self.dropout_rate, generator)
        out = x + ff
        if self.after_conv:
            out = F.max_pool1d(out.transpose(1, 2), 2).transpose(1, 2)
            if mask is not None:
                mask = mask[:, ::2, ::2]
        return out, mask


def _flatten_channel_major(h: torch.Tensor) -> torch.Tensor:
    """(B, C, T, F) -> (B, T, C * F), channel-major: the reference's
    ``transpose(1, 2).view(b, t, c * f)``, so its ``out`` weights map
    without reordering."""
    b, c, t, f = h.shape
    return h.transpose(1, 2).reshape(b, t, c * f)


class Conv2dSubsampling(nn.Module):
    """Two stride-2 3x3 unpadded convs (time / 4) + linear + PE."""

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.1):
        super().__init__()
        self.conv1 = nn.Conv2d(1, odim, 3, stride=2)
        self.conv2 = nn.Conv2d(odim, odim, 3, stride=2)
        self.out = nn.Linear(odim * (((idim - 1) // 2 - 1) // 2), odim)
        self.pos_enc = PositionalEncoding(odim, dropout_rate)

    def forward(self, x, generator=None):
        h = F.relu(self.conv1(x[:, None]))               # (B, 1, T, F)
        h = F.relu(self.conv2(h))
        return self.pos_enc(self.out(_flatten_channel_major(h)), generator)


class Conv2dNoSubsampling(nn.Module):
    """Two stride-1 3x3 same-padded convs + linear + PE."""

    def __init__(self, idim: int, odim: int, dropout_rate: float = 0.1):
        super().__init__()
        self.conv1 = nn.Conv2d(1, odim, 3, padding=1)
        self.conv2 = nn.Conv2d(odim, odim, 3, padding=1)
        self.out = nn.Linear(odim * idim, odim)
        self.pos_enc = PositionalEncoding(odim, dropout_rate)

    def forward(self, x, generator=None):
        h = F.relu(self.conv1(x[:, None]))
        h = F.relu(self.conv2(h))
        return self.pos_enc(self.out(_flatten_channel_major(h)), generator)


class LinearInputLayer(nn.Module):
    """Linear -> LN -> Dropout -> ReLU -> PE."""

    def __init__(self, idim: int, adim: int, dropout_rate: float = 0.1,
                 pos_enc: bool = True):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.linear = nn.Linear(idim, adim)
        self.norm = nn.LayerNorm(adim, eps=1e-5)
        self.pos_enc = PositionalEncoding(adim, dropout_rate) \
            if pos_enc else None

    def forward(self, x, generator=None):
        x = self.norm(self.linear(x))
        if self.training:
            x = dropout(x, self.dropout_rate, generator)
        x = F.relu(x)
        if self.pos_enc is not None:
            x = self.pos_enc(x, generator)
        return x


class TransformerEncoder(nn.Module):
    """ESPnet-style encoder: an input layer ('linear', 'conv2d' or
    'conv2d_no'), ``elayers`` pre-LN layers, a final LayerNorm."""

    def __init__(self, idim: int, adim: int = 144, dropout_rate: float = 0.1,
                 elayers: int = 3, eunits: int = 576, aheads: int = 4,
                 transformer_input_layer: str = 'conv2d',
                 transformer_attn_dropout_rate: float = 0.0,
                 after_conv: bool = False):
        super().__init__()
        self.transformer_input_layer = transformer_input_layer
        self.elayers = elayers
        if transformer_input_layer == 'linear':
            self.input_layer = LinearInputLayer(idim, adim, dropout_rate)
        elif transformer_input_layer == 'conv2d':
            self.input_layer = Conv2dSubsampling(idim, adim, dropout_rate)
        elif transformer_input_layer == 'conv2d_no':
            self.input_layer = Conv2dNoSubsampling(idim, adim, dropout_rate)
        else:
            raise ValueError(
                f'unknown input_layer: {transformer_input_layer}')
        for i in range(elayers):
            self.add_module(f'layer{i}', TransformerEncoderLayer(
                adim, aheads, eunits, dropout_rate,
                transformer_attn_dropout_rate, after_conv))
        self.norm = nn.LayerNorm(adim, eps=1e-12)

    def forward(self, x, mask=None, generator=None):
        x = self.input_layer(x, generator)
        if self.transformer_input_layer != 'linear':
            # the reference sets the mask to None in its conv input
            # layers; kept
            mask = None
        for i in range(self.elayers):
            x, mask = getattr(self, f'layer{i}')(x, mask, generator)
        return self.norm(x), mask


# ---------------------------------------------------------------------------
# Conformer
# ---------------------------------------------------------------------------


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift on (B, H, q, k) scores: pad one
    column on the left of the key axis, read the buffer as (k + 1, q),
    drop its first row."""
    b, h, q, k = x.shape
    x = F.pad(x, (1, 0)).view(b, h, k + 1, q)
    return x[:, :, 1:].reshape(b, h, q, k)


class RelMultiHeadAttn(nn.Module):
    """Pre-LN relative-position MHA with a shared QKV projection, the
    r_w / r_r biases and sinusoidal relative embeddings; the residual is
    included.  ``mask`` is (B, 1 | q, k) bool."""

    def __init__(self, n_head: int, d_model: int, dropout_rate: float = 0.1):
        super().__init__()
        self.n_head = n_head
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        d_head = d_model // n_head
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.qkv_net = nn.Linear(d_model, 3 * n_head * d_head, bias=False)
        self.r_net = nn.Linear(d_model, n_head * d_head, bias=False)
        self.r_w_bias = nn.Parameter(torch.zeros(n_head, d_head))
        self.r_r_bias = nn.Parameter(torch.zeros(n_head, d_head))
        self.o_net = nn.Linear(n_head * d_head, d_model, bias=False)

    def forward(self, x, mask=None, generator=None):
        with span('conformer.mhsa'):
            b, t, _ = x.shape
            h = self.n_head
            d_head = self.d_model // h
            q, k, v = torch.chunk(self.qkv_net(self.layer_norm(x)), 3,
                                  dim=-1)
            r_k = self.r_net(_rel_pos(t, self.d_model, x.device)
                             .to(x.dtype))
            q = q.view(b, t, h, d_head)
            k = k.view(b, t, h, d_head).permute(0, 2, 3, 1)  # (B,H,d,k)
            v = v.view(b, t, h, d_head).transpose(1, 2)      # (B,H,k,d)
            r_k = r_k.view(t, h, d_head).permute(1, 2, 0)    # (H,d,k)

            ac = torch.matmul((q + self.r_w_bias).transpose(1, 2), k)
            bd = torch.matmul((q + self.r_r_bias).transpose(1, 2), r_k)
            scores = (ac + rel_shift(bd)) / math.sqrt(d_head)
            if mask is not None:
                scores = scores.masked_fill(~mask[:, None], float('-inf'))
            attn = torch.softmax(scores, dim=-1)
            if self.training:
                attn = dropout(attn, self.dropout_rate, generator)
            out = torch.matmul(attn, v).transpose(1, 2).reshape(
                b, t, h * d_head)
            out = self.o_net(out)
            if self.training:
                out = dropout(out, self.dropout_rate, generator)
            return x + out


class ConvolutionModule(nn.Module):
    """LN -> pointwise to 2 d -> GLU -> depthwise k -> BN -> Swish ->
    pointwise -> dropout.  The BatchNorm normalises the channels of
    (B, T, C): flax momentum 0.9, eps 1e-5."""

    def __init__(self, d_model: int, dropout_rate: float = 0.1,
                 kernel_size: int = 7):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.pw1 = nn.Linear(d_model, 2 * d_model)
        self.dw = nn.Conv1d(d_model, d_model, kernel_size,
                            padding=kernel_size // 2, groups=d_model)
        self.bn = BatchNorm(d_model)
        self.pw2 = nn.Linear(d_model, d_model)

    def forward(self, x, generator=None):
        with span('conformer.conv'):
            a, g = torch.chunk(self.pw1(self.norm(x)), 2, dim=-1)
            h = (a * torch.sigmoid(g)).transpose(1, 2)       # (B, C, T)
            h = self.bn(self.dw(h)).transpose(1, 2)
            h = self.pw2(h * torch.sigmoid(h))
            if self.training:
                h = dropout(h, self.dropout_rate, generator)
            return h


class MacaronFeedForward(nn.Module):
    """LN -> Linear -> Swish -> Dropout -> Linear -> Dropout."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.w_1 = nn.Linear(d_model, d_ff)
        self.w_2 = nn.Linear(d_ff, d_model)

    def forward(self, x, generator=None):
        with span('conformer.ffn'):
            h = self.w_1(self.norm(x))
            h = h * torch.sigmoid(h)
            if self.training:
                h = dropout(h, self.dropout_rate, generator)
            h = self.w_2(h)
            if self.training:
                h = dropout(h, self.dropout_rate, generator)
            return h


class ConformerBlock(nn.Module):
    """Macaron block: half FFN, relative MHSA, conv module, half FFN,
    LayerNorm."""

    def __init__(self, d_model: int, d_ff: int, n_head: int,
                 dropout_rate: float = 0.1, kernel_size: int = 7):
        super().__init__()
        self.ffn1 = MacaronFeedForward(d_model, d_ff, dropout_rate)
        self.mhsa = RelMultiHeadAttn(n_head, d_model, dropout_rate)
        self.conv = ConvolutionModule(d_model, dropout_rate, kernel_size)
        self.ffn2 = MacaronFeedForward(d_model, d_ff, dropout_rate)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, mask=None, generator=None):
        x = 0.5 * self.ffn1(x, generator) + x
        x = self.mhsa(x, mask, generator)
        x = self.conv(x, generator) + x
        x = 0.5 * self.ffn2(x, generator) + x
        return self.norm(x)


class ConformerEncoder(nn.Module):
    """Linear input layer + ``elayers`` conformer blocks.

    Each forward runs inside a ``sed::conformer.encoder`` span, its
    blocks' parts inside ``sed::conformer.ffn``, ``conformer.mhsa`` and
    ``conformer.conv`` spans.  Counters: ``calls``, the encoder's
    forwards; ``tokens``, the batch x frames they took."""

    calls = 0
    tokens = 0

    def __init__(self, idim: int, adim: int = 144, dropout_rate: float = 0.1,
                 elayers: int = 3, eunits: int = 576, aheads: int = 4,
                 kernel_size: int = 7):
        super().__init__()
        self.elayers = elayers
        self.input_layer = LinearInputLayer(idim, adim, dropout_rate)
        for i in range(elayers):
            self.add_module(f'block{i}', ConformerBlock(
                adim, eunits, aheads, dropout_rate, kernel_size))

    def forward(self, x, mask=None, generator=None):
        ConformerEncoder.calls += 1
        ConformerEncoder.tokens += x.shape[0] * x.shape[1]
        with span('conformer.encoder'):
            x = self.input_layer(x, generator)
            for i in range(self.elayers):
                x = getattr(self, f'block{i}')(x, mask, generator)
            return x, mask


# ---------------------------------------------------------------------------
# DCASE baseline CNN
# ---------------------------------------------------------------------------


class GLUConv(nn.Module):
    """A linear map of the channels times the sigmoid of the input;
    (B, C, T, F)."""

    def __init__(self, channels: int):
        super().__init__()
        self.linear = nn.Linear(channels, channels)

    def forward(self, x):
        lin = self.linear(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return lin * torch.sigmoid(x)


class ContextGating(nn.Module):
    """x times the sigmoid of a linear map of its channels; (B, C, T, F)."""

    def __init__(self, channels: int):
        super().__init__()
        self.linear = nn.Linear(channels, channels)

    def forward(self, x):
        lin = self.linear(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x * torch.sigmoid(lin)


class BaselineCNN(nn.Module):
    """Configurable conv stack, per stage: conv (with bias) -> BN ->
    activation -> dropout -> avg pool.  (B, C_in, T, F) -> (B, C_out, T',
    F').  The BatchNorms have eps 1e-3 and the reference's torch momentum
    0.99 (flax 0.01): running = 0.01 running + 0.99 batch."""

    def __init__(self, in_channels: int = 1, activation: str = 'Relu',
                 conv_dropout: float = 0.0,
                 kernel_size: Sequence[int] = (3, 3, 3),
                 padding: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1),
                 nb_filters: Sequence[int] = (64, 64, 64),
                 pooling: Sequence[Tuple[int, int]] = ((1, 4), (1, 4),
                                                       (1, 4))):
        super().__init__()
        self.activation = activation.lower()
        self.conv_dropout = conv_dropout
        self.pooling = tuple(tuple(p) for p in pooling)
        self.stages = len(nb_filters)
        for i, ch in enumerate(nb_filters):
            self.add_module(f'conv{i}', nn.Conv2d(
                in_channels, ch, kernel_size[i], stride=stride[i],
                padding=padding[i]))
            self.add_module(f'bn{i}', BatchNorm(ch, eps=1e-3, momentum=0.99))
            if self.activation == 'glu':
                self.add_module(f'glu{i}', GLUConv(ch))
            elif self.activation == 'cg':
                self.add_module(f'cg{i}', ContextGating(ch))
            in_channels = ch

    def forward(self, x, generator=None):
        for i in range(self.stages):
            x = getattr(self, f'bn{i}')(getattr(self, f'conv{i}')(x))
            if self.activation == 'relu':
                x = F.relu(x)
            elif self.activation == 'leakyrelu':
                x = F.leaky_relu(x, 0.2)
            elif self.activation == 'glu':
                x = getattr(self, f'glu{i}')(x)
            elif self.activation == 'cg':
                x = getattr(self, f'cg{i}')(x)
            if self.training:
                x = dropout(x, self.conv_dropout, generator)
            if self.pooling[i] != (1, 1):
                x = F.avg_pool2d(x, self.pooling[i])
        return x
