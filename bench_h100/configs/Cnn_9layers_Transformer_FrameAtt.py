"""``Cnn_9layers_Transformer_FrameAtt``: its tensors, its plain reference
and its operations.

The configuration is ``Cnn_9layers_Transformer_FrameAtt.json`` beside
this file: the same conv stack as the GRU model -> one self-attention
block (``n_head`` heads of ``d_k`` over ``d_model``, output projection,
ReLU, no residual and no layer norm) -> attention head (the reference's
``pytorch/models.py:981-1077``); framewise output of 8 x the conv stack's
frames (496 for a 5 s clip), not padded.  Its weights (a copy of
``compat/bench_weights.transformer_variables``): ``bn0``, the conv stack
and the attention head from the trained GRU checkpoint, whose shapes they
share; the attention block drawn from the configuration's
``attention_seed``.
"""

import math

from bench_h100 import weights as W
from bench_h100.reference import plain

KEPT = ('bn0', 'conv_block1', 'conv_block2', 'conv_block3', 'conv_block4',
        'att_block')


def _sizes(config: dict, d: int) -> tuple:
    if config['d_model'] != d:
        raise ValueError(f'd_model {config["d_model"]} is not the conv '
                         f'stack\'s width {d}')
    return config['n_head'], config['d_k'], config['d_v']


def temporal_leaves(config: dict, d: int) -> tuple:
    """The attention block's leaves for a seeded draw: the query, key and
    value projections normal with variance 2 / (d + d_k), the output
    projection Xavier-normal, biases 0."""
    heads, d_k, d_v = _sizes(config, d)
    leaves = {}
    for n, w in (('w_qs', d_k), ('w_ks', d_k), ('w_vs', d_v)):
        leaves[f'multihead.{n}.weight'] = ('normal', (heads * w, d),
                                           math.sqrt(2.0 / (d + w)))
    leaves['multihead.fc.weight'] = ('normal', (d, heads * d_v),
                                     math.sqrt(2.0 / (d + heads * d_v)))
    for n, w in (('w_qs', d_k), ('w_ks', d_k), ('w_vs', d_v)):
        leaves[f'multihead.{n}.bias'] = ('zeros', (heads * w,), None)
    leaves['multihead.fc.bias'] = ('zeros', (d,), None)
    return d, leaves


def temporal_flop(config: dict, t: int, d: int) -> tuple:
    """The attention block's operations over ``t`` frames of width ``d``:
    the query, key, value and output projections (2 d width a frame
    each), 2 T^2 d_k a head for the scores and 2 T^2 d_v for the weighted
    values; and its output width."""
    heads, d_k, d_v = _sizes(config, d)
    proj = 2 * t * d * heads * (2 * d_k + 2 * d_v)
    return proj + 2 * t * t * heads * (d_k + d_v), d


def temporal(x, p: dict, config: dict):
    return plain.multihead(x, p, *_sizes(config, x.shape[-1]))


def weights(config: dict, seed: int, device, source: str) -> dict:
    if source != 'checkpoint':
        return W.seeded(config, seed, device, temporal_leaves)
    # the attention block from the configuration's own seed: the events a
    # clip (the host decode's work) follow these weights, so a block drawn
    # from the run's seed would change the work from seed to seed
    drawn = W.seeded(config, config['attention_seed'], device,
                     temporal_leaves)
    out = W.checkpoint(device, keep=KEPT)
    out.update({k: v for k, v in drawn.items() if k.startswith('multihead.')})
    return out


def program_model(config: dict, tensors: dict, cfg, device):
    """The program's model of this configuration, holding ``tensors``."""
    from sed_tpu_torch.models.registry import get_model
    model = get_model(config['model_type'], cfg,
                      classes_num=len(config['classes']),
                      conv_channels=tuple(config['conv_channels']))
    return W.load_into(model, tensors).to(device)


def reference(params: dict, wav, config: dict, **kw):
    """The plain reference's (framewise, clipwise)."""
    return plain.forward(params, wav, config, config['audio'],
                         lambda x, p: temporal(x, p, config), **kw)
