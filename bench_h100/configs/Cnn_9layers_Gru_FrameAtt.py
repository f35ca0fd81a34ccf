"""``Cnn_9layers_Gru_FrameAtt``: its tensors, its plain reference and its
operations.

The configuration is ``Cnn_9layers_Gru_FrameAtt.json`` beside this file:
4 ConvBlocks 64/128/256/512 -> BiGRU 512 -> 2 x 256 -> attention head over
25 classes (the reference's ``pytorch/models.py:564-688``), framewise
output padded to a multiple of 100 frames.  ``weights`` gives both sides
the same tensors: the repository's trained checkpoint
(``tools/bench_checkpoint.npz``), or a draw from the seed for training.
"""

import math

from bench_h100 import weights as W
from bench_h100.reference import plain


def temporal_leaves(config: dict, d: int) -> tuple:
    """The BiGRU's leaves for a seeded draw: each direction's gates
    uniform with variance 1 / D (inputs) and 1 / H (state), biases 0."""
    h = config['gru_hidden']
    leaves = {}
    for sfx in ('', '_reverse'):
        leaves[f'gru.weight_ih_l0{sfx}'] = ('uniform', (3 * h, d),
                                            math.sqrt(3.0 / d))
        leaves[f'gru.weight_hh_l0{sfx}'] = ('uniform', (3 * h, h),
                                            math.sqrt(3.0 / h))
    for sfx in ('', '_reverse'):
        for b in ('bias_ih_l0', 'bias_hh_l0'):
            leaves[f'gru.{b}{sfx}'] = ('zeros', (3 * h,), None)
    return 2 * h, leaves


def temporal_flop(config: dict, t: int, d: int) -> tuple:
    """The BiGRU's operations over ``t`` frames of width ``d``: per
    direction and frame 2 D 3H (inputs) + 2 H 3H (state); and its output
    width."""
    h = config['gru_hidden']
    return 2 * t * (2 * d * 3 * h + 2 * h * 3 * h), 2 * h


def weights(config: dict, seed: int, device, source: str) -> dict:
    if source == 'checkpoint':
        return W.checkpoint(device)
    return W.seeded(config, seed, device, temporal_leaves)


def program_model(config: dict, tensors: dict, cfg, device):
    """The program's model of this configuration, holding ``tensors``."""
    from sed_tpu_torch.models.registry import get_model
    model = get_model(config['model_type'], cfg,
                      classes_num=len(config['classes']),
                      conv_channels=tuple(config['conv_channels']),
                      gru_hidden=config['gru_hidden'])
    return W.load_into(model, tensors).to(device)


def reference(params: dict, wav, config: dict, **kw):
    """The plain reference's (framewise, clipwise)."""
    return plain.forward(params, wav, config, config['audio'], plain.bigru,
                         **kw)
