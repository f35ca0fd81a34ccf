"""Plain PyTorch reference of the Conformer encoder of
``Cnn_9layers_Conformer_FrameAtt`` (the reference's ``pytorch/models.py:
1189-1376`` and ``models_2020/conformer/``), for eval mode.

Written from the layer equations (Gulati et al. 2020, arXiv:2005.08100;
the relative-position attention of Transformer-XL, Dai et al. 2019,
arXiv:1901.02860), with no kernel, cache or batching of the program.  On
(B, T, idim) frames of the conv stack:

    input layer:  x = ReLU(LN(x W_in^T + b_in)) * sqrt(d) + PE[t]
                  PE[t, 2i] = sin(t / 10000^(2i/d)),
                  PE[t, 2i+1] = cos(t / 10000^(2i/d))
    each block:   x = x + FFN1(x) / 2
                  x = x + MHSA(x)
                  x = x + CONV(x)
                  x = LN(x + FFN2(x) / 2)
    FFN(x)  = W2 swish(W1 LN(x) + b1) + b2,   swish(z) = z sigmoid(z)
    MHSA(x) = W_o concat_h(softmax((A_h + shift(B_h)) / sqrt(d_h)) V_h)
              with [Q | K | V] = LN(x) W_qkv^T (no bias), R = E W_r^T,
              E[j] the embedding of relative distance T - 1 - j
              ([sin | cos] halves, not interleaved),
              A_h[i, j] = (Q_h[i] + u_h) . K_h[j],
              B_h[i, j] = (Q_h[i] + v_h) . R_h[j]
              (u, v: the learned ``r_w_bias``, ``r_r_bias``)
    CONV(x) = W_p2 swish(BN(depthwise_k(GLU(W_p1 LN(x) + b_p1)))) + b_p2
              GLU([a | g]) = a sigmoid(g); depthwise: k taps a channel,
              zero padding k // 2 on both sides, with bias; BN with the
              running statistics, eps 1e-5

``shift`` is Transformer-XL's relative shift, computed from its
definition with an explicit table of source positions: pad one zero
column on the left of the (q, k) scores, read the (q, k + 1) buffer as
(k + 1, q) in row-major order, drop its first row, and read the rest as
(q, k).  Output element (i, j) is therefore element i k + j + q of the
padded buffer.  For q = k = T this puts B_h[i, T - 1 - (i - j)] at
j <= i, the score of relative distance i - j; the entries above the
diagonal are the next row's values and zeros, as in the source (no mask).

Departures from the source: eval mode only (every dropout is the
identity); the (B, T, d) layout in place of the source's (T, B, d); the
positional and relative-position tables computed in float64 and rounded
to float32 once.
LayerNorm eps is 1e-5 everywhere, as in the source's Conformer modules.

Imports nothing of the program; ``p`` holds the program's ``state_dict``
names under ``encoder.``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
BN_EPS = 1e-5


def layer_norm(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[f'{name}.weight'] \
        + p[f'{name}.bias']


def linear(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    out = torch.matmul(x, p[f'{name}.weight'].t())
    bias = p.get(f'{name}.bias')
    return out if bias is None else out + bias


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def positional_table(t: int, d: int) -> np.ndarray:
    """(t, d): sin at even columns, cos at odd, of position / 10000^(2i/d)."""
    pos = np.arange(t, dtype=np.float64)[:, None]
    freq = 10000.0 ** (-np.arange(0, d, 2, dtype=np.float64) / d)
    table = np.zeros((t, d), np.float64)
    table[:, 0::2] = np.sin(pos * freq)
    table[:, 1::2] = np.cos(pos * freq)
    return table


def relative_table(t: int, d: int) -> np.ndarray:
    """(t, d): row j embeds relative distance t - 1 - j, sin half then
    cos half."""
    dist = np.arange(t - 1, -1, -1, dtype=np.float64)[:, None]
    freq = 10000.0 ** (-np.arange(0, d, 2, dtype=np.float64) / d)
    return np.concatenate([np.sin(dist * freq), np.cos(dist * freq)], axis=1)


def shift_source(q: int, k: int) -> np.ndarray:
    """(q, k) int64: for each output element, its source in the (q, k)
    scores flattened, or -1 for the padding zero.  Output (i, j) is
    element n = i k + j + q of the padded (q, k + 1) buffer, which is
    zero where n mod (k + 1) = 0 and score (n // (k + 1),
    n mod (k + 1) - 1) elsewhere."""
    n = np.arange(q, dtype=np.int64)[:, None] * k \
        + np.arange(k, dtype=np.int64)[None, :] + q
    row, col = np.divmod(n, k + 1)
    return np.where(col == 0, -1, row * k + col - 1)


def rel_shift(scores: torch.Tensor) -> torch.Tensor:
    """Transformer-XL's relative shift of (..., q, k) scores, by the
    table of ``shift_source``."""
    q, k = scores.shape[-2:]
    src = torch.from_numpy(shift_source(q, k)).to(scores.device)
    flat = scores.reshape(*scores.shape[:-2], q * k)
    padded = torch.cat([flat.new_zeros(*flat.shape[:-1], 1), flat], dim=-1)
    return padded[..., (src + 1).reshape(-1)].reshape(scores.shape)


def feed_forward(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    h = swish(linear(layer_norm(x, p, f'{name}.norm'), p, f'{name}.w_1'))
    return linear(h, p, f'{name}.w_2')


def attention(x: torch.Tensor, p: dict, name: str, heads: int,
              shift=rel_shift) -> torch.Tensor:
    """The relative-position self-attention, without its residual."""
    b, t, d = x.shape
    dh = d // heads
    qkv = linear(layer_norm(x, p, f'{name}.layer_norm'), p,
                 f'{name}.qkv_net')
    q, k, v = (part.reshape(b, t, heads, dh).transpose(1, 2)
               for part in qkv.split(d, dim=-1))            # (B, H, T, dh)
    table = torch.from_numpy(relative_table(t, d)).to(x.device, x.dtype)
    r = linear(table, p, f'{name}.r_net').reshape(t, heads, dh) \
        .transpose(0, 1)                                    # (H, T, dh)
    u = p[f'{name}.r_w_bias'][None, :, None, :]
    w = p[f'{name}.r_r_bias'][None, :, None, :]
    content = torch.matmul(q + u, k.transpose(-1, -2))       # (B, H, T, T)
    position = torch.matmul(q + w, r.transpose(-1, -2)[None])
    attn = torch.softmax((content + shift(position)) / math.sqrt(dh), dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, d)
    return linear(out, p, f'{name}.o_net')


def convolution(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    """The convolution module, without its residual."""
    a, g = linear(layer_norm(x, p, f'{name}.norm'), p,
                  f'{name}.pw1').chunk(2, dim=-1)
    h = (a * torch.sigmoid(g)).transpose(1, 2)              # (B, d, T)
    weight = p[f'{name}.dw.weight']                         # (d, 1, k)
    h = F.conv1d(h, weight, p[f'{name}.dw.bias'],
                 padding=weight.shape[-1] // 2, groups=h.shape[1])
    shape = (1, -1, 1)
    h = (h - p[f'{name}.bn.running_mean'].view(shape)) \
        / torch.sqrt(p[f'{name}.bn.running_var'].view(shape) + BN_EPS) \
        * p[f'{name}.bn.weight'].view(shape) + p[f'{name}.bn.bias'].view(shape)
    return linear(swish(h.transpose(1, 2)), p, f'{name}.pw2')


def encoder(x: torch.Tensor, p: dict, layers: int, heads: int,
            shift=rel_shift) -> torch.Tensor:
    """(B, T, idim) -> (B, T, d), every tensor under ``encoder.``."""
    h = linear(x, p, 'encoder.input_layer.linear')
    h = F.relu(layer_norm(h, p, 'encoder.input_layer.norm'))
    d = h.shape[-1]
    h = h * math.sqrt(d) + torch.from_numpy(
        positional_table(h.shape[1], d)).to(h.device, h.dtype)
    for i in range(layers):
        name = f'encoder.block{i}'
        h = h + 0.5 * feed_forward(h, p, f'{name}.ffn1')
        h = h + attention(h, p, f'{name}.mhsa', heads, shift)
        h = h + convolution(h, p, f'{name}.conv')
        h = layer_norm(h + 0.5 * feed_forward(h, p, f'{name}.ffn2'), p,
                       f'{name}.norm')
    return h
