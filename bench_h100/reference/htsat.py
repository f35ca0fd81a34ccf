"""Plain PyTorch reference of HTS-AT after ``bn0`` (Chen et al.,
arXiv:2202.00874; ``HTSAT_Swin_Transformer`` of
github.com/RetroCirce/HTS-Audio-Transformer ``model/htsat.py``), in
eval mode, written from its layer equations with no module, kernel or
batching of the program:

    (B, T, F) features -> stretch time to r S frames (bicubic, an explicit
    matrix) -> fold into an S x S image (r = S / F chunks of S frames
    stacked along the mel axis) -> patches p x p, Linear, LayerNorm ->
    stages of Swin blocks, PatchMerging between them -> LayerNorm ->
    unfold the last grid to (C, R / r, r R) -> Conv (R / r, 3) over it ->
    framewise sigmoid, each step repeated p 2^(stages - 1) times;
    clipwise sigmoid of the mean logit.

A Swin block, for tokens x on an R x R grid:
``x + Proj(WindowAttn(LN1(x)))``, then ``x + FC2(GELU(FC1(LN2(x))))``.
The window attention is written as one gather: ``window_index`` maps each
(window, position) to the grid token that the cyclic roll by -s and the
partition put there, so the roll, the partition, their reverse and the
roll back are that gather and the scatter back through the same map.
Scores ``q k^T / sqrt(d) + table[relative_index] + mask`` with the mask
-100 between tokens of different regions of the rolled grid
(``region_mask``), softmax written out, values, projection.

Imports nothing of the program.  ``dtype`` is the dtype everything runs
in (the correctness check's control runs bfloat16).  Parameters come by
the program's ``state_dict`` names; ``config`` gives the sizes
(``spec_size``, ``patch_size``, ``depths``, ``num_heads``,
``window_size``, ``mlp_ratio`` and the embed width from ``widths``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

LN_EPS = 1e-5
MASKED = -100.0
BICUBIC_A = -0.75
# PatchMerging's order of the 2 x 2 neighbours, (row, column) offsets
MERGE_ORDER = ((0, 0), (1, 0), (0, 1), (1, 1))


def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 matrix of cubic-convolution interpolation
    (A = -0.75) with ``align_corners=True``: output i samples input
    position i (n_in - 1) / (n_out - 1) from its four neighbours, indices
    clamped to the edges."""
    m = np.zeros((n_out, n_in))
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    a = BICUBIC_A
    for i in range(n_out):
        src = i * scale
        j = math.floor(src)
        t = src - j
        x = np.array([t + 1.0, t, 1.0 - t, 2.0 - t])
        near = ((a + 2) * x - (a + 3)) * x * x + 1           # |x| <= 1
        far = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a      # 1 < |x| < 2
        w = np.array([far[0], near[1], near[2], far[3]])
        for k, wk in zip(range(j - 1, j + 3), w):
            m[i, min(max(k, 0), n_in - 1)] += wk
    return m


def fold_index(f: int, chunks: int, width: int) -> np.ndarray:
    """(chunks F, width) index of each image pixel into the stretched
    (chunks width, F) features: row ``c F + m``, column ``t`` is frame
    ``c width + t`` of mel ``m``."""
    row = np.arange(chunks * f)[:, None]
    col = np.arange(width)[None, :]
    return (row // f * width + col) * f + row % f


def unfold_index(r: int, chunks: int) -> np.ndarray:
    """(R / chunks, chunks R) index of each head position into the
    row-major R x R grid: position (f, c R + t) is grid row
    ``c R / chunks + f``, column ``t``."""
    rows = r // chunks
    f = np.arange(rows)[:, None]
    u = np.arange(chunks * r)[None, :]
    return (u // r * rows + f) * r + u % r


def window_index(r: int, w: int, s: int) -> np.ndarray:
    """(nW, w^2) grid token (row-major on the R x R grid) that the roll by
    -s and the partition into w x w windows put at each position of each
    window (windows and positions row-major)."""
    n = r // w
    win = np.arange(n * n)
    pos = np.arange(w * w)
    row = (win[:, None] // n * w + pos[None, :] // w + s) % r
    col = (win[:, None] % n * w + pos[None, :] % w + s) % r
    return row * r + col


def region_mask(r: int, w: int, s: int) -> np.ndarray:
    """(nW, w^2, w^2) additive mask of a rolled grid: each rolled
    coordinate's region is 0 below r - w, 1 below r - s, else 2; tokens
    whose (row, column) regions differ score ``MASKED``."""
    n = r // w
    win = np.arange(n * n)
    pos = np.arange(w * w)
    row = win[:, None] // n * w + pos[None, :] // w
    col = win[:, None] % n * w + pos[None, :] % w

    def region(x):
        return (x >= r - w).astype(int) + (x >= r - s).astype(int)
    label = 3 * region(row) + region(col)
    return np.where(label[:, :, None] == label[:, None, :], 0.0, MASKED)


def relative_index(w: int) -> np.ndarray:
    """(w^2, w^2) row of the bias table for each (query, key) pair of a
    window: ``(di + w - 1) (2w - 1) + (dj + w - 1)``."""
    pos = np.arange(w * w)
    di = pos[:, None] // w - pos[None, :] // w
    dj = pos[:, None] % w - pos[None, :] % w
    return (di + w - 1) * (2 * w - 1) + (dj + w - 1)


def layer_norm(x, p: dict, name: str):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * p[f'{name}.weight'] \
        + p[f'{name}.bias']


def linear(x, p: dict, name: str):
    y = x @ p[f'{name}.weight'].t()
    bias = p.get(f'{name}.bias')
    return y if bias is None else y + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def softmax(x):
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def window_attention(x, p: dict, name: str, r: int, w: int, s: int,
                     heads: int):
    """(B, R^2, C) tokens -> the attention sub-block's output, (B, R^2, C),
    on windows of w rolled by -s (s = 0: no roll, no mask)."""
    b, _, c = x.shape
    d = c // heads
    dev = x.device
    idx = torch.from_numpy(window_index(r, w, s)).to(dev)    # (nW, N)
    nw, n = idx.shape
    win = x[:, idx.reshape(-1)].view(b, nw, n, c)
    qkv = linear(win, p, f'{name}.qkv').view(b, nw, n, 3, heads, d)
    q, k, v = (qkv[..., i, :, :].permute(0, 1, 3, 2, 4) for i in range(3))
    scores = torch.einsum('bwhid,bwhjd->bwhij', q, k) / math.sqrt(d)
    rel = torch.from_numpy(relative_index(w)).to(dev)
    table = p[f'{name}.relative_position_bias_table']
    scores = scores + table[rel].permute(2, 0, 1)             # (h, N, N)
    if s:
        mask = torch.from_numpy(region_mask(r, w, s)).to(x.dtype).to(dev)
        scores = scores + mask[None, :, None]
    out = torch.einsum('bwhij,bwhjd->bwhid', softmax(scores), v)
    out = linear(out.permute(0, 1, 3, 2, 4).reshape(b, nw, n, c), p,
                 f'{name}.proj')
    back = torch.empty_like(x)
    back[:, idx.reshape(-1)] = out.reshape(b, nw * n, c)
    return back


def block(x, p: dict, name: str, r: int, w: int, s: int, heads: int):
    x = x + window_attention(layer_norm(x, p, f'{name}.norm1'), p,
                             f'{name}.attn', r, w, s, heads)
    h = gelu(linear(layer_norm(x, p, f'{name}.norm2'), p, f'{name}.mlp.fc1'))
    return x + linear(h, p, f'{name}.mlp.fc2')


def patch_merging(x, p: dict, name: str, r: int):
    """(B, R^2, C) -> (B, (R/2)^2, 2C)."""
    b, _, c = x.shape
    grid = x.view(b, r, r, c)
    x = torch.cat([grid[:, i::2, j::2] for i, j in MERGE_ORDER], dim=-1)
    x = layer_norm(x.reshape(b, -1, 4 * c), p, f'{name}.norm')
    return linear(x, p, f'{name}.reduction')


def widths(config: dict) -> tuple:
    """(embed width, heads a stage): the published ones, or the rehearsal's
    narrowing (a non-empty ``conv_channels``: embed ``conv_channels[0]``,
    heads 1, 2, 4, ...)."""
    if config['conv_channels']:
        return (config['conv_channels'][0],
                [1 << i for i in range(len(config['depths']))])
    return config['embed_dim'], list(config['num_heads'])


def forward(p: dict, x, config: dict, frames_num: int) -> tuple:
    """(B, T, F) normalised features -> (framewise (B, frames_num, K),
    clipwise (B, K)) in float32; everything computed in ``x``'s dtype."""
    b, t, f = x.shape
    size, patch = config['spec_size'], config['patch_size']
    chunks = size // f
    dev, dtype = x.device, x.dtype
    if chunks * size != t:
        stretch = torch.from_numpy(bicubic_matrix(t, chunks * size)).to(
            dtype).to(dev)
        x = torch.einsum('ot,btf->bof', stretch, x)
    fold = torch.from_numpy(fold_index(f, chunks, size)).to(dev)
    image = x.reshape(b, -1)[:, fold.reshape(-1)].view(b, size, size)
    r = size // patch
    patches = image.view(b, r, patch, r, patch).permute(0, 1, 3, 2, 4) \
        .reshape(b, r * r, patch * patch)
    w_embed = p['patch_embed.proj.weight'].reshape(-1, patch * patch)
    x = patches @ w_embed.t() + p['patch_embed.proj.bias']
    x = layer_norm(x, p, 'patch_embed.norm')
    _, heads = widths(config)
    stages = len(config['depths'])
    for i, depth in enumerate(config['depths']):
        w = min(config['window_size'], r)
        for j in range(depth):
            s = w // 2 if j % 2 and r > w else 0
            x = block(x, p, f'encoder.layers.{i}.blocks.{j}', r, w, s,
                      heads[i])
        if i < stages - 1:
            x = patch_merging(x, p, f'encoder.layers.{i}.downsample', r)
            r //= 2
    x = layer_norm(x, p, 'encoder.norm')                      # (B, R^2, C)
    c = x.shape[-1]
    unfold = torch.from_numpy(unfold_index(r, chunks)).to(dev)
    rows, steps = unfold.shape
    u = x[:, unfold.reshape(-1)].view(b, rows, steps, c)
    wk = p['tscam_conv.weight']                               # (K, C, rows, 3)
    padded = torch.cat([u.new_zeros((b, rows, 1, c)), u,
                        u.new_zeros((b, rows, 1, c))], dim=2)
    logits = p['tscam_conv.bias'] + sum(
        torch.einsum('bftc,kcf->btk', padded[:, :, j:j + steps], wk[..., j])
        for j in range(3))                                    # (B, T', K)
    framewise = torch.sigmoid(logits).repeat_interleave(
        patch << (stages - 1), dim=1)[:, :frames_num]
    clipwise = torch.sigmoid(logits.mean(dim=1))
    return framewise.float(), clipwise.float()
