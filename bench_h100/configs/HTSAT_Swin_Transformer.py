"""``HTSAT_Swin_Transformer``: its tensors, its plain reference and its
operations.

The configuration is ``HTSAT_Swin_Transformer.json`` beside this file:
HTS-AT (Chen et al., arXiv:2202.00874; ``model/htsat.py`` of
github.com/RetroCirce/HTS-Audio-Transformer) at its published 32 kHz, 10 s
input: log-mel (n_fft 1024, hop 320, 64 mels 50-14000 Hz) -> ``bn0`` ->
the bicubic stretch to 1024 frames and the fold into a 256 x 256 image ->
4 x 4 patches of 96 -> Swin stages of 2, 2, 6, 2 blocks (widths 96 -> 768,
heads of 24, 8 x 8 windows, shifted every other block) with PatchMerging
between them -> LayerNorm -> the token-semantic head (``tscam_conv``
(2, 3) over the unfolded 2 x 32 grid) -> 32 framewise steps, each
repeated 32 times, cut to ``samples // hop`` frames.  The plain
reference is ``reference/plain.py``'s log-mel and ``bn0``, then
``reference/htsat.py``.

There is no conv stack (``conv_channels`` is empty): ``temporal_flop``
counts the whole body after log-mel and gives width 0, so that the
yardstick adds no head of its own.  A non-empty ``conv_channels`` is the
rehearsal's narrowing: embed width ``conv_channels[0]``, widths doubling
per stage, heads 1, 2, 4, 8, every other size as published.

Weights (``fixed``): every tensor drawn from the configuration's
``model_seed``, so that every run seed serves the same model and the same
decode work; ``seeded`` draws them from the run's seed.  The laws
(``assumed``): Xavier-uniform linear and convolution weights, so that
q k^T is O(1) and the softmax is far from uniform; the relative-position
tables normal with deviation 1, so that the bias moves the softmax;
LayerNorm scales 1 + U(-s, s), shifts and every bias U(-s, s); ``bn0``'s
running statistics the log-mel statistics of the traffic generator's
clips (a trained ``bn0`` holds its training set's), its scale and shift
around neutral.  With ``fixed`` every class's ``tscam_conv`` bias is the
configuration's ``tscam_bias``.
"""

import math

import torch

from bench_h100 import common, generate
from bench_h100.reference import htsat, plain

# the spread of the drawn norm affines and biases around neutral
NORM_SPREAD = 0.1
# generator clips whose log-mel statistics are bn0's running statistics
BN0_CLIPS = 8


def _stages(config: dict) -> list:
    """[(width, heads, depth, grid side, window)] of each stage."""
    embed, heads = htsat.widths(config)
    r = config['spec_size'] // config['patch_size']
    out = []
    for i, depth in enumerate(config['depths']):
        side = r >> i
        out.append((embed << i, heads[i], depth, side,
                    min(config['window_size'], side)))
    return out


def leaves(config: dict) -> dict:
    """Every tensor of the program's model but ``bn0``, by its
    ``state_dict`` name: (law, shape, scale), the law ``xavier`` (scale:
    the bound), ``normal`` (the deviation), ``uniform`` (the bound) or
    ``norm`` (1 + U(-scale, scale))."""
    p, s = config['patch_size'], NORM_SPREAD
    out = {}

    def xavier(name, shape, bias=True):
        receptive = math.prod(shape[2:])
        bound = math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
        out[f'{name}.weight'] = ('xavier', shape, bound)
        if bias:
            out[f'{name}.bias'] = ('uniform', (shape[0],), s)

    def norm(name, width):
        out[f'{name}.weight'] = ('norm', (width,), s)
        out[f'{name}.bias'] = ('uniform', (width,), s)
    stages = _stages(config)
    embed = stages[0][0]
    xavier('patch_embed.proj', (embed, 1, p, p))
    norm('patch_embed.norm', embed)
    mlp = config['mlp_ratio']
    for i, (c, heads, depth, _, window) in enumerate(stages):
        for j in range(depth):
            b = f'encoder.layers.{i}.blocks.{j}'
            norm(f'{b}.norm1', c)
            out[f'{b}.attn.relative_position_bias_table'] = (
                'normal', ((2 * window - 1) ** 2, heads), 1.0)
            xavier(f'{b}.attn.qkv', (3 * c, c))
            xavier(f'{b}.attn.proj', (c, c))
            norm(f'{b}.norm2', c)
            xavier(f'{b}.mlp.fc1', (int(c * mlp), c))
            xavier(f'{b}.mlp.fc2', (c, int(c * mlp)))
        if i < len(stages) - 1:
            norm(f'encoder.layers.{i}.downsample.norm', 4 * c)
            xavier(f'encoder.layers.{i}.downsample.reduction', (2 * c, 4 * c),
                   bias=False)
    c, side = stages[-1][0], stages[-1][3]
    norm('encoder.norm', c)
    rows = side * config['audio']['mel_bins'] // config['spec_size']
    xavier('tscam_conv', (len(config['classes']), c, rows, 3))
    return out


def _bn0(config: dict, seed: int, gen, device) -> dict:
    """``bn0``: running mean and variance the per-mel log-mel statistics
    of ``BN0_CLIPS`` 10 s generator clips drawn from ``seed``; scale and
    shift around neutral."""
    a = config['audio']
    clips, _ = generate.make_clips(BN0_CLIPS, a['sample_rate'], 10, seed,
                                   config['classes'])
    with torch.no_grad():
        feats = plain.logmel(torch.from_numpy(clips).to(device), a)
    m = a['mel_bins']
    u = (torch.rand(2, m, generator=gen, device=device) * 2.0 - 1.0) \
        * NORM_SPREAD
    return {'bn0.running_mean': feats.mean(dim=(0, 1)),
            'bn0.running_var': feats.var(dim=(0, 1)),
            'bn0.weight': 1.0 + u[0], 'bn0.bias': u[1]}


def weights(config: dict, seed: int, device, source: str) -> dict:
    """Every tensor of the model, drawn on ``device`` from the
    configuration's ``model_seed`` (``fixed``) or from ``seed``
    (``seeded``): one uniform and one normal buffer."""
    if source not in ('fixed', 'seeded'):
        raise ValueError(f'{config["name"]}: no weights from {source!r} '
                         '(fixed or seeded)')
    seed = config['model_seed'] if source == 'fixed' else seed
    gen = torch.Generator(device=device).manual_seed(int(seed))
    laws = leaves(config)
    uni = [k for k, (law, _, _) in laws.items() if law != 'normal']
    nrm = [k for k, (law, _, _) in laws.items() if law == 'normal']
    out = {}
    for names, draw in ((uni, torch.rand), (nrm, torch.randn)):
        sizes = [math.prod(laws[k][1]) for k in names]
        flat = draw(sum(sizes), generator=gen, device=device)
        for k, part in zip(names, flat.split(sizes)):
            law, shape, scale = laws[k]
            if law == 'normal':
                out[k] = (part * scale).view(shape)
            else:
                centred = (part * 2.0 - 1.0) * scale
                out[k] = (1.0 + centred if law == 'norm'
                          else centred).view(shape)
    out.update(_bn0(config, seed + 1, gen, device))
    if source == 'fixed':
        out['tscam_conv.bias'] = torch.full_like(out['tscam_conv.bias'],
                                                 config['tscam_bias'])
    return out


def program_model(config: dict, tensors: dict, cfg, device):
    """The program's model of this configuration, holding ``tensors``."""
    from bench_h100 import weights as W
    from sed_tpu_torch.models.registry import get_model
    embed, heads = htsat.widths(config)
    model = get_model(config['model_type'], cfg,
                      classes_num=len(config['classes']),
                      spec_size=config['spec_size'],
                      patch_size=config['patch_size'], embed_dim=embed,
                      depths=tuple(config['depths']), num_heads=tuple(heads),
                      window_size=config['window_size'],
                      mlp_ratio=config['mlp_ratio'])
    return W.load_into(model, tensors).to(device)


def reference(params: dict, wav, config: dict, dtype=torch.float32):
    """The plain reference's (framewise, clipwise) of (B, samples) float32
    waveforms; everything after log-mel in ``dtype``, float32 products
    without TF32."""
    common.full_precision(config)
    a = config['audio']
    x = plain.logmel(wav, a).to(dtype)                        # (B, T, F)
    x = plain.batch_norm(x.transpose(1, 2), params, 'bn0', False, None)
    return htsat.forward(params, x.transpose(1, 2), config,
                         wav.shape[-1] // a['hop_size'])


def _counts(config: dict) -> tuple:
    """(patch embedding, encoder, head) operations of one clip,
    multiply-adds as 2: the linears (qkv, projection, MLP: 24 C^2 a token
    a block at ``mlp_ratio`` 4; PatchMerging 8 C^2 a merged token), the
    attention's two products (4 N d a token a head: 4 N C a token), the
    patch embedding (2 D p^2 a token) and ``tscam_conv``.  Not counted:
    norms, GELU, softmax, the bias and mask, the stretch."""
    p, mlp = config['patch_size'], config['mlp_ratio']
    stages = _stages(config)
    embed = 2 * stages[0][0] * p * p * stages[0][3] ** 2
    enc = 0
    for i, (c, _, depth, side, window) in enumerate(stages):
        tokens = side * side
        per_token = 2 * (4 * c * c + 2 * mlp * c * c) \
            + 4 * window * window * c
        enc += depth * tokens * per_token
        if i < len(stages) - 1:
            enc += (tokens // 4) * 2 * (4 * c) * (2 * c)
    c, side = stages[-1][0], stages[-1][3]
    rows = side * config['audio']['mel_bins'] // config['spec_size']
    steps = side * side // rows
    head = steps * len(config['classes']) * 2 * c * rows * 3
    return embed, enc, head


def temporal_flop(config: dict, t: int, d: int) -> tuple:
    """The whole body's operations after log-mel for one clip (``t`` and
    ``d``, the frames and width a conv stack would hand on, are not used:
    the image is the model's fixed input), and width 0: the
    token-semantic head is counted here, so the yardstick's head term
    adds nothing."""
    return float(sum(_counts(config))), 0


def encoder_flop(config: dict) -> float:
    """The encoder's operations a clip: the stages and PatchMerging."""
    return float(_counts(config)[1])


def encoder_bytes(config: dict, clips: float = 1) -> float:
    """Bytes the encoder must move for one forward of ``clips`` clips,
    float32: each of its weights read once, each clip's stage-1 tokens in
    and stage-4 tokens out once."""
    weights_n = sum(math.prod(shape) for k, (_, shape, _) in
                    leaves(config).items() if k.startswith('encoder.'))
    stages = _stages(config)
    io = stages[0][0] * stages[0][3] ** 2 + stages[-1][0] * stages[-1][3] ** 2
    return 4.0 * (weights_n + clips * io)
