"""``Cnn_9layers_Conformer_FrameAtt``: its tensors, its plain reference and
its operations.

The configuration is ``Cnn_9layers_Conformer_FrameAtt.json`` beside this
file: the same conv stack as the GRU model -> a Conformer encoder (a
Linear ``512 -> adim`` input layer with LayerNorm, ReLU and scaled
sinusoidal positions, then ``elayers`` macaron blocks of ``aheads``
relative-position heads, a feed-forward width ``eunits`` and a depthwise
kernel ``kernel_size``) -> attention head over ``adim`` (the reference's
``pytorch/models.py:1189-1376``); framewise output of 8 x the conv
stack's frames, padded to a multiple of 100.  The encoder's plain
reference is ``reference/conformer.py``.

Weights (``checkpoint``): ``bn0`` and the conv stack from the trained GRU
checkpoint, whose shapes they share; the encoder and the ``adim``-wide
head drawn from the configuration's ``encoder_seed``, so that every run
seed serves the same model and the same decode work.  Every encoder leaf
is drawn from a law that is not constant (the configuration's
``assumed`` lists them): lecun-normal weights and uniform biases of the
linear and depthwise layers, uniform ``r_w_bias`` / ``r_r_bias``, and
LayerNorm and BatchNorm scales, shifts and running statistics around 1
and 0, so the comparison on the card covers every term.  The head's
class bias is the configuration's ``cla_bias``, so that the served model
emits about as many events a clip as a trained one (``assumed``).
"""

import math

import torch

from bench_h100 import weights as W
from bench_h100.reference import conformer, plain

KEPT = ('bn0', 'conv_block1', 'conv_block2', 'conv_block3', 'conv_block4')
# the spread of the drawn LayerNorm and BatchNorm affines and running
# statistics around their neutral values (scale and variance 1 + U(-s, s),
# shift and mean U(-s, s))
NORM_SPREAD = 0.1


def _sizes(config: dict) -> tuple:
    return (config['adim'], config['aheads'], config['elayers'],
            config['eunits'], config['kernel_size'])


def _linear(leaves: dict, name: str, fan_in: int, fan_out: int,
            bias: bool = True) -> None:
    leaves[f'{name}.weight'] = ('normal', (fan_out, fan_in),
                                1.0 / math.sqrt(fan_in))
    if bias:
        leaves[f'{name}.bias'] = ('uniform', (fan_out,),
                                  1.0 / math.sqrt(fan_in))


def _norm(leaves: dict, name: str, width: int, stats: bool = False) -> None:
    keys = ('weight', 'bias') + (('running_mean', 'running_var')
                                 if stats else ())
    for key in keys:
        leaves[f'{name}.{key}'] = ('uniform', (width,), NORM_SPREAD)


def temporal_leaves(config: dict, d: int) -> tuple:
    """The encoder's leaves for a seeded draw, by the program's names:
    every linear and depthwise weight normal with variance 1 / fan-in,
    their biases uniform within 1 / sqrt(fan-in), the relative-position
    biases uniform within 1 / sqrt(head width), and the LayerNorm and
    BatchNorm leaves uniform within ``NORM_SPREAD`` (``weights`` moves the
    scales and variances to 1 + that)."""
    adim, heads, layers, units, kernel = _sizes(config)
    dh = adim // heads
    leaves = {}
    _linear(leaves, 'encoder.input_layer.linear', d, adim)
    _norm(leaves, 'encoder.input_layer.norm', adim)
    for i in range(layers):
        b = f'encoder.block{i}'
        for ffn in ('ffn1', 'ffn2'):
            _norm(leaves, f'{b}.{ffn}.norm', adim)
            _linear(leaves, f'{b}.{ffn}.w_1', adim, units)
            _linear(leaves, f'{b}.{ffn}.w_2', units, adim)
        _norm(leaves, f'{b}.mhsa.layer_norm', adim)
        _linear(leaves, f'{b}.mhsa.qkv_net', adim, 3 * adim, bias=False)
        _linear(leaves, f'{b}.mhsa.r_net', adim, adim, bias=False)
        _linear(leaves, f'{b}.mhsa.o_net', adim, adim, bias=False)
        for bias in ('r_w_bias', 'r_r_bias'):
            leaves[f'{b}.mhsa.{bias}'] = ('uniform', (heads, dh),
                                          1.0 / math.sqrt(dh))
        _norm(leaves, f'{b}.conv.norm', adim)
        _linear(leaves, f'{b}.conv.pw1', adim, 2 * adim)
        leaves[f'{b}.conv.dw.weight'] = ('normal', (adim, 1, kernel),
                                         1.0 / math.sqrt(kernel))
        leaves[f'{b}.conv.dw.bias'] = ('uniform', (adim,),
                                       1.0 / math.sqrt(kernel))
        _norm(leaves, f'{b}.conv.bn', adim, stats=True)
        _linear(leaves, f'{b}.conv.pw2', adim, adim)
        _norm(leaves, f'{b}.norm', adim)
    return adim, leaves


def temporal_flop(config: dict, t: int, d: int) -> tuple:
    """The encoder's operations over ``t`` frames of width ``d`` (one
    clip), multiply-adds as 2: the input layer (2 d adim a frame); per
    block and frame the two feed-forwards (2 x 2 x 2 adim eunits), the
    QKV and output projections (2 adim 3 adim + 2 adim adim), the conv
    module's pointwise layers (2 adim 2 adim + 2 adim adim) and depthwise
    taps (2 kernel adim); per block and clip the content and position
    scores and the weighted values (3 x 2 t^2 adim); and its output
    width.  Not counted: norms, activations, softmax, and the relative
    embeddings' projection (2 t adim adim a block), which a forward makes
    once for all its clips."""
    adim, _, layers, units, kernel = _sizes(config)
    block = t * (2 * 2 * 2 * adim * units + 2 * adim * 3 * adim
                 + 2 * adim * adim + 2 * adim * 2 * adim + 2 * adim * adim
                 + 2 * kernel * adim) + 3 * 2 * t * t * adim
    return t * 2 * d * adim + layers * block, adim


def temporal_bytes(config: dict, t: int, d: int, clips: int = 1) -> int:
    """Bytes the encoder must move for one forward of ``clips`` clips of
    ``t`` frames, float32: each of its weights read once, each clip's
    (t, d) input read once and its (t, adim) output written once."""
    _, leaves = temporal_leaves(config, d)
    params = sum(math.prod(shape) for _, shape, _ in leaves.values())
    return 4 * (params + clips * t * (d + config['adim']))


def temporal(x, p: dict, config: dict, shift=conformer.rel_shift):
    return conformer.encoder(x, p, config['elayers'], config['aheads'],
                             shift)


def _centred(drawn: dict) -> dict:
    """The drawn norm scales and running variances moved to 1 + U."""
    return {k: (1.0 + v if k.endswith(('norm.weight', 'bn.weight',
                                       'running_var')) and
                k.startswith('encoder.') else v)
            for k, v in drawn.items()}


def weights(config: dict, seed: int, device, source: str) -> dict:
    if source != 'checkpoint':
        return _centred(W.seeded(config, seed, device, temporal_leaves))
    # the encoder and head from the configuration's own seed: the events a
    # clip (the host decode's work) follow these weights, so ones drawn
    # from the run's seed would change the work from seed to seed
    drawn = _centred(W.seeded(config, config['encoder_seed'], device,
                              temporal_leaves))
    out = W.checkpoint(device, keep=KEPT)
    out.update({k: v for k, v in drawn.items()
                if k.startswith(('encoder.', 'att_block.'))})
    out['att_block.cla.bias'] = torch.full_like(out['att_block.cla.bias'],
                                                config['cla_bias'])
    return out


def program_model(config: dict, tensors: dict, cfg, device):
    """The program's model of this configuration, holding ``tensors``."""
    from sed_tpu_torch.models.conformer_zoo import CONFORMER_KW
    from sed_tpu_torch.models.registry import get_model
    mine = dict(zip(('adim', 'aheads', 'elayers', 'eunits', 'kernel_size'),
                    _sizes(config)))
    theirs = {k: CONFORMER_KW[k] for k in mine}
    if mine != theirs:
        raise ValueError(f'configuration {mine} is not the program\'s '
                         f'Conformer {theirs}')
    model = get_model(config['model_type'], cfg,
                      classes_num=len(config['classes']),
                      conv_channels=tuple(config['conv_channels']))
    return W.load_into(model, tensors).to(device)


def reference(params: dict, wav, config: dict, shift=conformer.rel_shift,
              **kw):
    """The plain reference's (framewise, clipwise); ``shift``: the
    relative shift the encoder applies (the tests leave it out)."""
    return plain.forward(params, wav, config, config['audio'],
                         lambda x, p: temporal(x, p, config, shift), **kw)
