"""HTS-AT, the hierarchical token-semantic audio transformer (Chen et al.,
ICASSP 2022, arXiv:2202.00874; ``HTSAT_Swin_Transformer`` of
github.com/RetroCirce/HTS-Audio-Transformer ``model/htsat.py``, sizes in
its ``config.py``), in eval mode.  The port's first model with no conv
stack: a Swin encoder over the log-mel image and a framewise head.

Layer equations (``model/htsat.py`` names in brackets), at the published
sizes for a 10 s clip at 32 kHz (n_fft 1024, hop 320, 64 mels):

- log-mel (B, T = 1001, F = 64), then ``bn0`` over the mel bins
  (``SedFeatureBase``);
- stretch and fold [``reshape_wav2img``]: with r = ``spec_size`` // F
  (4), time is stretched to r * ``spec_size`` (1024) frames by bicubic
  interpolation (A = -0.75, ``align_corners=True``, edges clamped; the
  mel axis unchanged), then cut into r chunks of ``spec_size`` frames
  stacked along the mel axis: image row ``c * F + m``, column ``t``
  holds frame ``c * spec_size + t`` of mel ``m``.  The stretch is
  upstream's ``F.interpolate`` run in float64 (``stretch``): in float32
  it takes each source position in float32, which at 1001 frames is off
  by up to 2^-15 of a frame and moves unit-scale features by ~1.6e-4;
- patch embedding [``PatchEmbed``]: Conv2d(1 -> D, kernel = stride =
  ``patch_size``), then LayerNorm: a (64, 64) grid of D = 96 tokens, no
  absolute position embedding;
- four stages [``BasicLayer``] of ``depths`` (2, 2, 6, 2) blocks at widths
  D, 2D, 4D, 8D with ``num_heads`` (4, 8, 16, 32) heads of 24.  A block
  [``SwinTransformerBlock``] is
  ``x + Attn(LN1(x))`` then ``x + FC2(GELU(FC1(LN2(x))))`` (exact GELU,
  hidden ``mlp_ratio`` 4 x).  Attn [``WindowAttention``] cuts the grid
  into ``window_size`` x ``window_size`` windows (N = 64 tokens) and, in
  each, for every head:
  ``softmax(q k^T / sqrt(24) + B[rel(i, j)] + M) v`` with qkv bias, the
  learned table B of (2w - 1)^2 = 225 x heads indexed by the relative
  offset ``(di + w - 1) * (2w - 1) + (dj + w - 1)``, then the output
  projection.  Every odd block of a stage whose grid is larger than a
  window rolls the grid by -w/2 on both axes first and back after, and M
  is -100 between tokens of different regions of the rolled grid
  (regions cut at -w and -w/2 on each axis), else 0; an even block, or a
  grid of one window (stage 4's 8 x 8), has no roll and M = 0;
- between stages [``PatchMerging``]: each 2 x 2 neighbourhood
  concatenated in the order (0, 0), (1, 0), (0, 1), (1, 1) (row, column
  offsets), LayerNorm(4C), Linear(4C -> 2C) without bias;
- the final LayerNorm [``norm``];
- token-semantic head [``forward_features`` with ``enable_tscam``]: the
  (8, 8) grid of 768 unfolded back to (768, 8 / r, r * 8) = (768, 2, 32),
  grid row ``c * 2 + f``, column ``t`` going to (f, c * 8 + t);
  ``tscam_conv`` Conv2d(768 -> classes, kernel (2, 3), padding (0, 1))
  gives 32 logits a class; framewise output sigmoid(logits), each step
  repeated ``patch_size`` * 2^(stages - 1) = 32 times (1024 frames), cut
  to ``samples // hop`` frames (1000: upstream keeps the 1024 of the
  stretched clip, which misaligns the clip's end by up to 0.23 s);
  clipwise output sigmoid(mean over time of the logits).

The stages and the final norm live under ``encoder`` (upstream's
``layers`` and ``norm``: its checkpoint's names map by that prefix; its
unused ``head`` Linear has no counterpart).  ``encoder`` runs inside a
``sed::htsat.encoder`` span, each block's attention sub-block (roll,
partition, qkv, scores, bias, mask, softmax, values, projection, reverse,
roll back) inside ``sed::htsat.attn``, and the head inside
``sed::htsat.head``.  Counters on ``SwinEncoder``: ``windows``, the
attention windows over all blocks (186 a 10 s clip: 64 * 2 + 16 * 2 +
4 * 6 + 1 * 2), and ``tokens``, the tokens through the blocks (11904 a
clip).

Narrowing (tests and rehearsals): ``embed_dim``, ``num_heads``,
``depths``, ``window_size``, ``spec_size`` and the mel bins may be given;
the benchmark's rehearsal builds embed width ``conv_channels[0]`` with
the widths doubling per stage and heads 1, 2, 4, 8.

Eval only: training mode (SpecAugment, mixup, stochastic depth 0.1 in
upstream) is not ported, and a training-mode forward raises.  float32
only: ``compute_dtype`` other than None raises.  A clip longer than the
model's input (more than r * ``spec_size`` frames; 10.24 s) raises:
upstream's overlapped crops of long clips are not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.base import SedFeatureBase
from sed_tpu_torch.utils.profiling import span

MASKED = -100.0     # Swin's score between tokens of different regions


def stretch(x: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, 1, T, F) -> (B, 1, ``frames``, F): bicubic interpolation along
    time (``align_corners=True``), computed in float64."""
    return F.interpolate(x.double(), (frames, x.shape[-1]), mode='bicubic',
                         align_corners=True).to(x.dtype)


def relative_position_index(window: int) -> torch.Tensor:
    """(N, N) index into the (2w - 1)^2 bias table of each pair of a
    window's N = w^2 tokens (row-major in the window)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window),
                                        indexing='ij')).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]) + (window - 1)
    return rel[0] * (2 * window - 1) + rel[1]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window^2, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int,
                   w: int) -> torch.Tensor:
    """(B * nW, window^2, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    x = x.view(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def shift_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """(nW, N, N) additive mask of a rolled grid: ``MASKED`` between
    tokens of different regions, 0 within one."""
    label = torch.zeros(h, w)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for i, hs in enumerate(cuts):
        for j, ws in enumerate(cuts):
            label[hs, ws] = 3 * i + j
    win = window_partition(label[None, :, :, None], window)[..., 0]
    same = win[:, :, None] == win[:, None, :]
    return torch.where(same, 0.0, MASKED)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside each window, with the learned
    relative-position bias: explicit batched matmuls and softmax."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer('relative_position_index',
                             relative_position_index(window),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(B * nW, N, C) windows; ``mask`` (nW, N, N) or None."""
        bw, n, c = x.shape
        h = self.heads
        qkv = self.qkv(x).view(bw, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                              # (B nW, h, N, d)
        scores = torch.matmul(q * self.scale, k.transpose(-2, -1))
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, h) \
            .permute(2, 0, 1)                                # (h, N, N)
        if mask is None:
            scores = scores + bias
        else:
            nw = mask.shape[0]
            scores = (scores.view(bw // nw, nw, h, n, n)
                      + (mask[:, None] + bias)).view(bw, h, n, n)
        out = torch.matmul(scores.softmax(dim=-1), v)        # (B nW, h, N, d)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-norm (shifted-)window attention and MLP, each with a residual,
    over a (B, H, W, C) grid."""

    def __init__(self, dim: int, heads: int, resolution: int, window: int,
                 shift: int, mlp_ratio: float):
        super().__init__()
        if resolution <= window:     # one window: no partition, no roll
            window, shift = resolution, 0
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.register_buffer(
            'attn_mask', shift_mask(resolution, resolution, window, shift)
            if shift else None, persistent=False)

    def windows(self, h: int, w: int) -> int:
        return (h // self.window) * (w // self.window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        y = self.norm1(x)
        with span('htsat.attn'):
            if self.shift:
                y = torch.roll(y, (-self.shift, -self.shift), (1, 2))
            y = window_reverse(
                self.attn(window_partition(y, self.window), self.attn_mask),
                self.window, h, w)
            if self.shift:
                y = torch.roll(y, (self.shift, self.shift), (1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """(B, H, W, C) -> (B, H/2, W/2, 2C): 2 x 2 neighbours concatenated in
    the order (0, 0), (1, 0), (0, 1), (1, 1), LayerNorm, Linear."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, resolution: int,
                 window: int, mlp_ratio: float, merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, resolution, window,
                      0 if i % 2 == 0 else window // 2, mlp_ratio)
            for i in range(depth)])
        self.downsample = PatchMerging(dim) if merge else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class SwinEncoder(nn.Module):
    """The stages and the final LayerNorm over a (B, R, R, D) token grid.

    Each forward runs inside a ``sed::htsat.encoder`` span.  Counters:
    ``windows``, the attention windows of every block over the batch;
    ``tokens``, the tokens every block took."""

    windows = 0
    tokens = 0

    def __init__(self, embed_dim: int, depths: Sequence[int],
                 heads: Sequence[int], resolution: int, window: int,
                 mlp_ratio: float):
        super().__init__()
        self.layers = nn.ModuleList()
        self.windows_a_clip = self.tokens_a_clip = 0
        for i, (depth, h) in enumerate(zip(depths, heads)):
            res = resolution >> i
            if res % min(window, res):
                raise ValueError(f'stage {i + 1}: a {res} x {res} grid does '
                                 f'not divide into {window} x {window} '
                                 'windows')
            stage = SwinStage(embed_dim << i, depth, h, res, window,
                              mlp_ratio, merge=i < len(depths) - 1)
            self.layers.append(stage)
            self.windows_a_clip += sum(b.windows(res, res)
                                       for b in stage.blocks)
            self.tokens_a_clip += depth * res * res
        self.num_features = embed_dim << (len(depths) - 1)
        self.norm = nn.LayerNorm(self.num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        SwinEncoder.windows += x.shape[0] * self.windows_a_clip
        SwinEncoder.tokens += x.shape[0] * self.tokens_a_clip
        with span('htsat.encoder'):
            for layer in self.layers:
                x = layer(x)
            return self.norm(x)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(1, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, S, S) image -> (B, S/p, S/p, D) token grid."""
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class HtsatSed(SedFeatureBase):
    """``HTSAT_Swin_Transformer`` in eval mode: waveform (B, samples) ->
    ``framewise_output`` (B, samples // hop, classes) and
    ``clipwise_output`` (B, classes)."""

    def __init__(self, cfg, classes_num: int = 25,
                 feature_type: str = 'logmel', compute_dtype=None,
                 spec_size: int = 256, patch_size: int = 4,
                 embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32),
                 window_size: int = 8, mlp_ratio: float = 4.0):
        if feature_type != 'logmel':
            raise ValueError('HTSAT_Swin_Transformer takes waveforms '
                             f'(log-mel), not {feature_type} features')
        if compute_dtype is not None:
            raise ValueError('HTSAT_Swin_Transformer runs float32 only')
        super().__init__(cfg, feature_type)
        if spec_size % cfg.mel_bins:
            raise ValueError(f'spec_size {spec_size} is not a multiple of '
                             f'{cfg.mel_bins} mel bins')
        self.spec_size, self.patch_size = spec_size, patch_size
        self.freq_ratio = spec_size // cfg.mel_bins
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        grid = spec_size // patch_size
        self.encoder = SwinEncoder(embed_dim, depths, num_heads, grid,
                                   window_size, mlp_ratio)
        last = grid >> (len(depths) - 1)
        if last % self.freq_ratio:
            raise ValueError(f'the last {last} x {last} grid does not fold '
                             f'into {self.freq_ratio} chunks')
        self.tscam_conv = nn.Conv2d(self.encoder.num_features, classes_num,
                                    (last // self.freq_ratio, 3),
                                    padding=(0, 1))
        # each head step covers patch_size * 2^(stages - 1) frames
        self.frames_a_step = patch_size << (len(depths) - 1)

    def _image(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, T, F) features -> the (B, 1, S, S) image: time stretched
        to r * S frames, cut into r chunks stacked along the mel axis."""
        b, _, t, f = x.shape
        target = self.freq_ratio * self.spec_size
        if t > target:
            raise ValueError(f'{t} frames: HTSAT_Swin_Transformer takes at '
                             f'most {target}')
        if t < target:
            x = stretch(x, target)
        x = x.permute(0, 1, 3, 2).reshape(b, 1, f, self.freq_ratio,
                                          self.spec_size)
        return x.permute(0, 1, 3, 2, 4).reshape(b, 1, self.freq_ratio * f,
                                                self.spec_size)

    def _head(self, x: torch.Tensor, frames_num: int) -> dict:
        """(B, R, R, C) final grid -> framewise and clipwise outputs."""
        b, r, _, c = x.shape
        x = x.permute(0, 3, 1, 2).reshape(b, c, self.freq_ratio,
                                          r // self.freq_ratio, r)
        x = x.permute(0, 1, 3, 2, 4).reshape(b, c, r // self.freq_ratio,
                                             self.freq_ratio * r)
        logits = self.tscam_conv(x).flatten(2)               # (B, K, T')
        framewise = blocks.interpolate(
            torch.sigmoid(logits).transpose(1, 2), self.frames_a_step)
        return {'framewise_output': framewise[:, :frames_num],
                'clipwise_output': torch.sigmoid(logits.mean(dim=2))}

    def forward(self, wav: torch.Tensor,
                mixup_lambda: Optional[torch.Tensor] = None,
                timeshift: bool = False, spec_augment: bool = True,
                generator: Optional[torch.Generator] = None) -> dict:
        if self.training:
            raise NotImplementedError('HTSAT_Swin_Transformer runs in eval '
                                      'mode only')
        frames_num = wav.shape[-1] // self.cfg.hop_size
        x = self.compute_features(wav)                       # (B, 1, T, F)
        x = self.encoder(self.patch_embed(self._image(x)))
        with span('htsat.head'):
            return self._head(x, frames_num)
