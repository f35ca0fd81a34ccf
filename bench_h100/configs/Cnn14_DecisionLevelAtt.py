"""``Cnn14_DecisionLevelAtt``: its tensors, its plain reference and its
operations.

The configuration is ``Cnn14_DecisionLevelAtt.json`` beside this file:
PANNs CNN14 with decision-level attention (Kong et al., arXiv:1912.10211;
the reference's ``pytorch/models.py:2685-2783``) at its published 32 kHz
front end: 6 ConvBlocks 64 -> 2048 (average pools after the first five)
-> mean over mel bins -> the 3-wide max + average smoothing, fc1 2048 ->
2048 and ReLU (``reference/panns.py``) -> attention head over 25 classes
-> each frame repeated 32 times, padded to ``samples // hop`` frames.
The reference runs ``reference/plain.py``'s log-mel, ``bn0``, conv stack
and head around that block; its pad to a multiple of 100 frames
(``pad_to_roundup``) is that pad at whole seconds, where ``samples //
hop`` is 100 a second.

Weights (``checkpoint``): ``bn0`` and blocks 1-4 from the trained GRU
checkpoint, whose shapes CNN14's first four blocks share; blocks 5-6,
fc1 and the head drawn from the configuration's ``head_seed``, so that
every run seed serves the same model and the same decode work.  Blocks
5-6's BatchNorm leaves are drawn around neutral and fc1's bias is drawn
(``assumed``), so the comparison on the card covers every term.  The
head's class bias is the configuration's ``cla_bias``.
"""

import math

import torch

from bench_h100 import weights as W
from bench_h100.reference import panns, plain

KEPT = ('bn0', 'conv_block1', 'conv_block2', 'conv_block3', 'conv_block4')
# the spread of blocks 5-6's drawn BatchNorm leaves around neutral (scale
# and running variance 1 + U(-s, s), shift and running mean U(-s, s))
NORM_SPREAD = 0.1


def temporal_leaves(config: dict, d: int) -> tuple:
    """fc1's leaves for a seeded draw: the weight Xavier-uniform, the
    bias uniform within 1 / sqrt(d); and its output width."""
    w = config['fc_width']
    return w, {'fc1.weight': ('uniform', (w, d), math.sqrt(6.0 / (d + w))),
               'fc1.bias': ('uniform', (w,), 1.0 / math.sqrt(d))}


def temporal_flop(config: dict, t: int, d: int) -> tuple:
    """The block's operations over ``t`` frames of width ``d`` (one
    clip), multiply-adds as 2: fc1 (2 d w a frame) and the smoothing (6 a
    value: two comparisons, two additions and a scale for the average,
    one addition of the two); and its output width."""
    w = config['fc_width']
    return t * (2 * d * w + 6 * d), w


def temporal_bytes(config: dict, t: int, d: int, clips: int = 1) -> int:
    """Bytes the block must move for one forward of ``clips`` clips of
    ``t`` frames, float32: fc1's weight and bias read once, each clip's
    (t, d) input read once and its (t, w) output written once."""
    w = config['fc_width']
    return 4 * (w * d + w + clips * t * (d + w))


def _norms(config: dict, seed: int, device) -> dict:
    """The BatchNorm leaves of the blocks beyond the checkpoint's four,
    drawn around neutral from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for i, c in enumerate(config['conv_channels'][len(KEPT) - 1:],
                          len(KEPT)):
        for j in (1, 2):
            for key, centre in (('weight', 1.0), ('bias', 0.0),
                                ('running_mean', 0.0),
                                ('running_var', 1.0)):
                u = torch.rand(c, generator=gen, device=device)
                out[f'conv_block{i}.bn{j}.{key}'] = \
                    centre + (2.0 * u - 1.0) * NORM_SPREAD
    return out


def weights(config: dict, seed: int, device, source: str) -> dict:
    if source != 'checkpoint':
        out = W.seeded(config, seed, device, temporal_leaves)
        out.update(_norms(config, seed + 1, device))
        return out
    # blocks 5-6, fc1 and the head from the configuration's own seed: the
    # events a clip (the host decode's work) follow these weights, so ones
    # drawn from the run's seed would change the work from seed to seed
    drawn = W.seeded(config, config['head_seed'], device, temporal_leaves)
    drawn.update(_norms(config, config['head_seed'] + 1, device))
    out = W.checkpoint(device, keep=KEPT)
    out.update({k: v for k, v in drawn.items()
                if k.split('.')[0] not in KEPT})
    out['att_block.cla.bias'] = torch.full_like(out['att_block.cla.bias'],
                                                config['cla_bias'])
    return out


def program_model(config: dict, tensors: dict, cfg, device):
    """The program's model of this configuration, holding ``tensors``.
    The published widths are the class's own; a narrowed stack (the
    rehearsal's, the tests') is passed as ``conv_channels``."""
    from sed_tpu_torch.models.panns import Cnn14DecisionLevelAtt
    from sed_tpu_torch.models.registry import get_model
    channels = tuple(config['conv_channels'])
    kw = {} if channels == Cnn14DecisionLevelAtt.conv_channels else \
        {'conv_channels': channels}
    model = get_model(config['model_type'], cfg,
                      classes_num=len(config['classes']), **kw)
    if model.fc1.out_features != config['fc_width']:
        raise ValueError(f'configuration fc_width {config["fc_width"]} is '
                         f'not the program\'s {model.fc1.out_features}')
    return W.load_into(model, tensors).to(device)


def reference(params: dict, wav, config: dict, temporal=panns.head, **kw):
    """The plain reference's (framewise, clipwise); ``temporal``: the
    block after the conv stack (the tests alter it)."""
    return plain.forward(params, wav, config, config['audio'], temporal,
                         **kw)
