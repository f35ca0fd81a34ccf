"""Plain PyTorch reference of the SED models the benchmark runs.

Written from the layer equations of the reference's ``pytorch/models.py``
(``Cnn_9layers_Gru_FrameAtt``, ``Cnn_9layers_Transformer_FrameAtt``) and
its log-mel frontend, with no kernel, cache or batching of the program:

    wav -> |STFT|^2 (periodic Hann, center reflect pad) -> Slaney mel
        -> 10 log10 -> bn0 over mel bins -> 4 x [conv3x3 - BN - ReLU] x 2
        (2x2 average pool after the first three) -> mean over mel bins
        -> the configuration's temporal block (a BiGRU of r, z, n gates,
        or one self-attention block with ReLU and no residual) ->
        attention head (sigmoid classes)
        -> each frame repeated 8 times (padded to a multiple of 100 by
        repeating the last frame where the model pads)

Training mode adds the reference's augmentations in the order the model
applies them (SpecAugment, then timeshift and mixup), BatchNorm on the
batch's statistics (running statistics moved toward the biased batch
variance, momentum 0.1), and flax-form AMSGrad.  The random draws are
made from the caller's ``torch.Generator`` in the reference's order, so a
run seeded alike draws alike.

Imports nothing of the program.  ``dtype`` runs everything after the
log-mel frontend in that dtype: the control of the correctness check
runs it in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


# ---------------------------------------------------------------------------
# log-mel frontend
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3)
    log_t = f >= 1000.0
    return np.where(log_t, 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0)
                    / (np.log(6.4) / 27.0), mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f = m * (200.0 / 3)
    return np.where(m >= 15.0,
                    1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """librosa's ``filters.mel`` (Slaney scale and area norm) transposed:
    (n_fft // 2 + 1, n_mels) float64."""
    fft_f = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    weights *= (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    return weights.T


def logmel(wav: torch.Tensor, audio: dict) -> torch.Tensor:
    """(B, samples) float32 -> (B, T, mel_bins) log-mel in float32."""
    n_fft, hop = audio['window_size'], audio['hop_size']
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                               device=wav.device)
    spec = torch.stft(wav.float(), n_fft, hop, window=window, center=True,
                      pad_mode='reflect', return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2                  # (B, bins, T)
    mel_fb = torch.from_numpy(mel_filterbank(
        audio['sample_rate'], n_fft, audio['mel_bins'], audio['fmin'],
        audio['fmax'])).float().to(wav.device)
    mel = torch.matmul(power.transpose(1, 2), mel_fb)        # (B, T, M)
    return 10.0 * torch.log10(torch.clamp(mel, min=audio['amin'])) \
        - 10.0 * math.log10(max(audio['amin'], audio['ref']))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def batch_norm(x: torch.Tensor, p: dict, name: str, train: bool,
               stats: dict | None) -> torch.Tensor:
    """Normalise over dim 1 of (B, C, ...).  Eval: running statistics.
    Train: batch mean and biased variance; the running ones (in
    ``stats``, updated in place) move toward them."""
    dims = [0] + list(range(2, x.dim()))
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    if train:
        mean = x.mean(dim=dims)
        var = ((x - mean.view(shape)) ** 2).mean(dim=dims)
        if stats is not None:
            with torch.no_grad():
                for key, val in (('running_mean', mean), ('running_var', var)):
                    s = stats[f'{name}.{key}']
                    s.mul_(1.0 - BN_MOMENTUM).add_(val.detach().to(s.dtype),
                                                   alpha=BN_MOMENTUM)
    else:
        mean = p[f'{name}.running_mean']
        var = p[f'{name}.running_var']
    inv = torch.rsqrt(var + BN_EPS)
    return (x - mean.view(shape)) * (inv * p[f'{name}.weight']).view(shape) \
        + p[f'{name}.bias'].view(shape)


def gru_direction(x: torch.Tensor, p: dict, suffix: str,
                  reverse: bool) -> torch.Tensor:
    """One GRU direction over (B, T, D): r, z, n gates with
    n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h = (1 - z) n + z h."""
    w_ih, w_hh = p['gru.weight_ih_l0' + suffix], p['gru.weight_hh_l0' + suffix]
    b_ih, b_hh = p['gru.bias_ih_l0' + suffix], p['gru.bias_hh_l0' + suffix]
    b, t, _ = x.shape
    hidden = w_hh.shape[1]
    gi = torch.matmul(x, w_ih.t()) + b_ih                    # (B, T, 3H)
    h = x.new_zeros((b, hidden))
    out = [None] * t
    steps = range(t - 1, -1, -1) if reverse else range(t)
    for i in steps:
        gh = torch.matmul(h, w_hh.t()) + b_hh
        i_r, i_z, i_n = gi[:, i].chunk(3, dim=1)
        h_r, h_z, h_n = gh.chunk(3, dim=1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
        out[i] = h
    return torch.stack(out, dim=1)


def bigru(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The bidirectional GRU: both directions' states, concatenated."""
    return torch.cat([gru_direction(x, p, '', False),
                      gru_direction(x, p, '_reverse', True)], dim=2)


def multihead(x: torch.Tensor, p: dict, heads: int, d_k: int,
              d_v: int) -> torch.Tensor:
    """One self-attention block: ``heads`` heads, output projection,
    ReLU."""
    b, t, _ = x.shape

    def proj(name, width):
        return F.linear(x, p[f'multihead.{name}.weight'],
                        p[f'multihead.{name}.bias']) \
            .view(b, t, heads, width).transpose(1, 2)
    q, k, v = proj('w_qs', d_k), proj('w_ks', d_k), proj('w_vs', d_v)
    attn = torch.softmax(torch.matmul(q, k.transpose(2, 3))
                         / math.sqrt(d_k), dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, heads * d_v)
    return F.relu(F.linear(out, p['multihead.fc.weight'],
                           p['multihead.fc.bias']))


# ---------------------------------------------------------------------------
# augmentations (training mode), drawn from the caller's generator
# ---------------------------------------------------------------------------

def _stripes(x: torch.Tensor, axis: int, width: int, generator):
    """Zero 2 stripes a row along ``axis``: widths U[0, width), starts
    floor(u * (total - width))."""
    b, total = x.shape[0], x.shape[axis]
    dist = torch.randint(0, width, (b, 2), generator=generator,
                         device=x.device)
    u = torch.rand((b, 2), generator=generator, device=x.device)
    bgn = torch.floor(u * (total - dist)).long()
    pos = torch.arange(total, device=x.device)
    hit = (pos >= bgn[:, :, None]) & (pos < (bgn + dist)[:, :, None])
    keep = (~hit.any(dim=1)).to(x.dtype)
    shape = [b, 1, 1, 1]
    shape[axis] = total
    return x * keep.view(shape)


def augment(x: torch.Tensor, lam: torch.Tensor, generator) -> torch.Tensor:
    """(B, 1, T, F) features: SpecAugment (time, then frequency), a roll
    of the batch by trunc(N(0, 90)) frames, then mixup of consecutive
    pairs (halves the batch)."""
    x = _stripes(x, 2, 64, generator)
    x = _stripes(x, 3, 8, generator)
    shift = int(torch.trunc(90.0 * torch.randn(
        (), generator=generator, device=x.device)).item())
    x = torch.roll(x, shift, dims=2)
    return mix(x, lam)


def mix(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    lam = lam.to(x.dtype).view((-1,) + (1,) * (x.dim() - 1))
    return x[0::2] * lam[0::2] + x[1::2] * lam[1::2]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def forward(p: dict, wav: torch.Tensor, model: dict, audio: dict,
            temporal, dtype=torch.float32, train: bool = False, stats=None,
            lam=None, generator=None) -> tuple:
    """(B, samples) -> (framewise (B', T', C), clipwise (B', C)), float32.
    ``p``: the model's tensors by the program's ``state_dict`` names (in
    ``dtype``); ``temporal(x, p)``: the configuration's block between the
    conv stack and the head.  Train mode with ``lam``: the augmentations,
    B' = B / 2."""
    x = logmel(wav, audio).transpose(1, 2).to(dtype)          # (B, M, T)
    x = batch_norm(x, p, 'bn0', train, stats)
    x = x.transpose(1, 2)[:, None]                            # (B,1,T,M)
    if train and lam is not None:
        x = augment(x, lam, generator)
    blocks = len(model['conv_channels'])
    for i in range(blocks):
        name = f'conv_block{i + 1}'
        for j in (1, 2):
            x = F.conv2d(x, p[f'{name}.conv{j}.weight'], padding=1)
            x = F.relu(batch_norm(x, p, f'{name}.bn{j}', train, stats))
        if i < blocks - 1:
            x = F.avg_pool2d(x, 2)
    x = x.mean(dim=3).transpose(1, 2)                         # (B, T', C)
    x = temporal(x, p)
    att = torch.clamp(F.linear(x, p['att_block.att.weight'],
                               p['att_block.att.bias']), -10.0, 10.0)
    att = torch.exp(att) + 1e-6
    norm_att = att / att.sum(dim=1, keepdim=True)
    cla = torch.sigmoid(F.linear(x, p['att_block.cla.weight'],
                                 p['att_block.cla.bias']))
    clipwise = (norm_att * cla).sum(dim=1)
    framewise = torch.repeat_interleave(cla, 2 ** (blocks - 1), dim=1)
    frames = framewise.shape[1]
    if model['pad_to_roundup'] and frames % 100:
        pad = 100 - frames % 100
        framewise = torch.cat(
            [framewise, framewise[:, -1:].expand(-1, pad, -1)], dim=1)
    return framewise.float(), clipwise.float()


def bce(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy, log terms clamped at -100."""
    return torch.mean(-(t * torch.clamp_min(torch.log(p), -100.0)
                        + (1.0 - t) * torch.clamp_min(torch.log1p(-p),
                                                      -100.0)))


def amsgrad_(params: dict, grads: dict, state: dict, t: int,
             lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8) -> None:
    """One flax-form AMSGrad step in place: the running maximum of the
    bias-corrected second moment."""
    with torch.no_grad():
        for k, g in grads.items():
            s = state.setdefault(k, {'mu': torch.zeros_like(g),
                                     'nu': torch.zeros_like(g),
                                     'nu_max': torch.zeros_like(g)})
            s['mu'].mul_(b1).add_(g, alpha=1.0 - b1)
            s['nu'].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
            torch.maximum(s['nu_max'], s['nu'] / bc2, out=s['nu_max'])
            params[k].sub_(lr * (s['mu'] / bc1)
                           / (torch.sqrt(s['nu_max']) + eps))
