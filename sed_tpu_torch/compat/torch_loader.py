"""The reference's ``.pth`` state-dict names -> flax variable trees (a
copy of ``sed_tpu/compat/torch_loader.py:state_dict_to_variables`` and
its name map).

The reference saves ``{'iteration', 'model': model.module.state_dict(),
'optimizer': ...}`` via ``torch.save`` (``pytorch/main_strong.py:326-334``).
The port reads the file with ``torch.load`` (``compat/from_flax.py``) and
maps the state dict's keys here onto the flax-layout tree that
``from_flax`` turns into a PyTorch ``state_dict`` of its own models.
Every family of ``models/registry.py`` is mapped: CNN, CNN + BiGRU, CNN
+ MultiHead, the Conformer / ESPnet encoder package, the DCASE baseline
CNN, VGGish and CNN14.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# state_dict -> flax variables
# ---------------------------------------------------------------------------

# torch keys that carry no information for the rebuilt models: the frozen
# DSP frontend weights (recomputed here), vestigial blocks never used in
# the reference forward, and BN bookkeeping.
_SKIP_SUBSTRINGS = (
    'spectrogram_extractor.', 'logmel_extractor.', 'stft_extractor.',
    'gamma_extractor.', 'cqt_extractor.',
    'att_block.bn_att.', 'multihead.layer_norm.',
    'num_batches_tracked',
)


# registered buffers recomputed in the forward here: sinusoidal positional
# tables (``transformer/embedding.py:20-31``) and the rel-attention
# inverse-frequency table (``conformer/attention.py:125-133``)
_BUFFER_LEAVES = ('pe', 'inv_freq')


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


# ---------------------------------------------------------------------------
# encoder-package key mapping (DCASE-2020 Conformer / ESPnet Transformer,
# ``pytorch/models_2020/``) and DCASE baseline CNN (``baseline_model.py``)
# ---------------------------------------------------------------------------

# ffn Sequential indices (``conformer/macaron_feed_forward.py:9-16``)
_FFN_SUBMAP = {'0': ('norm', 'ln'), '1': ('w_1', 'linear'),
               '4': ('w_2', 'linear')}
# ConvolutionModule Sequential indices (``conformer/convolution.py:38-51``)
_CONVMOD_SUBMAP = {'0': ('norm', 'ln'), '1': ('pw1', 'pw'),
                   '3': ('dw', 'dw'), '5': ('bn', 'bn'),
                   '8': ('pw2', 'pw')}


def _encoder_owner(owner: Tuple[str, ...]):
    """Reference ``encoder.*`` owner path -> (flax path, weight kind).

    Covers the ConformerEncoder (``conformer_encoder.py:21-28``: Sequential
    input layer; ``conformer_block.py:9-14``: ffn1/mhsa/conv/ffn2/norm) and
    the ESPnet TransformerEncoder (``transformer/encoder.py:34-71``).
    """
    rest = owner[1:]
    if rest == ('norm',):                          # final encoder LN
        return ('encoder', 'norm'), 'ln'
    if rest and rest[0] == 'input_layer':
        sub = rest[1:]
        if sub == ('0',):
            return ('encoder', 'input_layer', 'linear'), 'linear'
        if sub == ('1',):
            return ('encoder', 'input_layer', 'norm'), 'ln'
        if sub == ('conv', '0'):
            return ('encoder', 'input_layer', 'conv1'), 'conv2d'
        if sub == ('conv', '2'):
            return ('encoder', 'input_layer', 'conv2'), 'conv2d'
        if sub == ('out', '0'):
            return ('encoder', 'input_layer', 'out'), 'linear'
        raise KeyError(f'unmapped encoder input_layer key: {owner}')
    if rest and rest[0] == 'conformer_blocks':
        ours = ('encoder', f'block{rest[1]}')
        sub = rest[2:]
        if sub and sub[0] in ('ffn1', 'ffn2'):
            name, kind = _FFN_SUBMAP[sub[2]]       # sub[1]='feed_forward_module'
            return ours + (sub[0], name), kind
        if sub and sub[0] == 'mhsa':
            if sub[1] == 'layer_norm':
                return ours + ('mhsa', 'layer_norm'), 'ln'
            if sub[1] in ('qkv_net', 'o_net', 'r_net'):
                return ours + ('mhsa', sub[1]), 'linear'
            raise KeyError(f'unmapped mhsa key: {owner}')
        if sub and sub[0] == 'conv':
            name, kind = _CONVMOD_SUBMAP[sub[2]]   # sub[1]='conv'
            return ours + ('conv', name), kind
        if sub == ('norm',):
            return ours + ('norm',), 'ln'
        raise KeyError(f'unmapped conformer block key: {owner}')
    if rest and rest[0] == 'encoders':             # ESPnet encoder layers
        ours = ('encoder', f'layer{rest[1]}')
        sub = rest[2:]
        if sub and sub[0] == 'self_attn':
            return ours + ('self_attn', sub[1]), 'linear'
        if sub and sub[0] == 'feed_forward':
            return ours + ('feed_forward', sub[1]), 'linear'
        if sub in (('norm1',), ('norm2',)):
            return ours + sub, 'ln'
        raise KeyError(f'unmapped transformer layer key: {owner}')
    raise KeyError(f'unmapped encoder key: {owner}')


def _baseline_cnn_owner(owner: Tuple[str, ...]):
    """``cnn.cnn.*`` (DCASE baseline CNN Sequential,
    ``baseline_model.py:50-74``) -> BaselineCNN path."""
    name = owner[2]
    if name.startswith('conv'):
        return ('cnn', name), 'conv2d'
    if name.startswith('batchnorm'):
        return ('cnn', 'bn' + name[len('batchnorm'):]), 'bn'
    if name.startswith(('glu', 'cg')):             # inner .linear
        return ('cnn', name, 'linear'), 'linear'
    raise KeyError(f'unmapped baseline CNN key: {owner}')


def _assign(kind: str, ours: Tuple[str, ...], leaf: str, val: np.ndarray,
            params: dict, batch_stats: dict, key: str):
    """Place one torch tensor into the flax trees by weight kind."""
    if kind == 'ln':
        _set(params, (*ours, 'scale' if leaf == 'weight' else 'bias'), val)
    elif kind == 'linear':
        _set(params, (*ours, 'kernel' if leaf == 'weight' else 'bias'),
             val.T if leaf == 'weight' else val)
    elif kind == 'conv2d':                         # OIHW -> HWIO
        _set(params, (*ours, 'kernel' if leaf == 'weight' else 'bias'),
             val.transpose(2, 3, 1, 0) if leaf == 'weight' else val)
    elif kind == 'pw':                             # Conv1d 1x1 -> Dense
        _set(params, (*ours, 'kernel' if leaf == 'weight' else 'bias'),
             val[:, :, 0].T if leaf == 'weight' else val)
    elif kind == 'dw':                             # (C,1,K) -> (K,1,C)
        _set(params, (*ours, 'kernel' if leaf == 'weight' else 'bias'),
             val.transpose(2, 1, 0) if leaf == 'weight' else val)
    elif kind == 'bn':
        if leaf == 'weight':
            _set(params, (*ours, 'scale'), val)
        elif leaf == 'bias':
            _set(params, (*ours, 'bias'), val)
        elif leaf == 'running_mean':
            _set(batch_stats, (*ours, 'mean'), val)
        elif leaf == 'running_var':
            _set(batch_stats, (*ours, 'var'), val)
        else:
            raise KeyError(f'unhandled BN key {key}')
    else:
        raise KeyError(f'unknown weight kind {kind} for {key}')


def state_dict_to_variables(state_dict: Dict[str, np.ndarray]) -> dict:
    """Map a reference model state_dict onto sed_tpu flax variables.

    Handles: bn0 / conv blocks / GRU / AttBlock (1x1 conv1d -> Dense) /
    MultiHead + fc linears.  Unknown keys raise so silent drift is
    impossible.
    """
    params: dict = {}
    batch_stats: dict = {}

    for key, val in state_dict.items():
        if key.startswith('module.'):
            key = key[len('module.'):]
        if any(s in key for s in _SKIP_SUBSTRINGS):
            continue
        parts = key.split('.')
        leaf = parts[-1]
        owner = parts[:-1]
        oname = '.'.join(owner)

        if leaf in _BUFFER_LEAVES:         # recomputed positional tables
            continue

        # --- DCASE-2020 encoder package (Conformer / ESPnet Transformer)
        if parts[0] == 'encoder':
            if leaf in ('r_w_bias', 'r_r_bias'):
                # encoder.conformer_blocks.{i}.mhsa.r_{w,r}_bias,
                # (n_head, d_head) params stored verbatim
                _set(params, ('encoder', f'block{parts[2]}', 'mhsa', leaf),
                     val)
                continue
            ours, kind = _encoder_owner(tuple(owner))
            _assign(kind, ours, leaf, val, params, batch_stats, key)
            continue

        # --- DCASE baseline CNN (``cnn.cnn.*``) ----------------------------
        if len(parts) >= 3 and parts[0] == 'cnn' and parts[1] == 'cnn':
            ours, kind = _baseline_cnn_owner(tuple(owner))
            _assign(kind, ours, leaf, val, params, batch_stats, key)
            continue

        # --- BatchNorm (bn0, conv_blockN.bn{1,2}) -------------------------
        if parts[-2].startswith('bn') or parts[-2] == 'bn0':
            if leaf == 'weight':
                _set(params, (*owner, 'scale'), val)
            elif leaf == 'bias':
                _set(params, (*owner, 'bias'), val)
            elif leaf == 'running_mean':
                _set(batch_stats, (*owner, 'mean'), val)
            elif leaf == 'running_var':
                _set(batch_stats, (*owner, 'var'), val)
            else:
                raise KeyError(f'unhandled BN key {key}')
            continue

        # --- VGGish Sequential indices -> conv{i}
        # (torch keys vggish.features.{0,3,6,8,11,13}.*, models.py:2230-2250)
        if 'vggish' in parts and parts[-2].isdigit():
            seq_to_conv = {0: 'conv0', 3: 'conv1', 6: 'conv2', 8: 'conv3',
                           11: 'conv4', 13: 'conv5'}
            conv_name = seq_to_conv.get(int(parts[-2]))
            if conv_name is None:
                continue  # fc stack is stripped by the reference too
            if leaf == 'weight':
                _set(params, ('vggish', conv_name, 'kernel'),
                     val.transpose(2, 3, 1, 0))
            else:
                _set(params, ('vggish', conv_name, 'bias'), val)
            continue

        # --- conv layers (OIHW -> HWIO) -----------------------------------
        if parts[-2].startswith('conv') and leaf == 'weight' and val.ndim == 4:
            _set(params, (*owner, 'kernel'), val.transpose(2, 3, 1, 0))
            continue

        # --- GRU ----------------------------------------------------------
        if parts[-2] == 'gru' or (len(parts) >= 2 and parts[0] == 'gru'):
            direction = 'bw' if leaf.endswith('_reverse') else 'fw'
            base = leaf.replace('_reverse', '')
            name = {'weight_ih_l0': 'w_ih', 'weight_hh_l0': 'w_hh',
                    'bias_ih_l0': 'b_ih', 'bias_hh_l0': 'b_hh'}[base]
            _set(params, ('gru', direction, name), val)
            continue

        # --- AttBlock 1x1 conv1d (O, I, 1) -> Dense kernel (I, O) ---------
        if 'att_block' in oname and val.ndim == 3:
            _set(params, (*owner, 'kernel'), val[:, :, 0].T)
            continue
        if 'att_block' in oname and leaf == 'bias':
            _set(params, (*owner, 'bias'), val)
            continue

        # --- Linear layers (out, in) -> kernel (in, out) -------------------
        if leaf == 'weight' and val.ndim == 2:
            _set(params, (*owner, 'kernel'), val.T)
            continue
        if leaf == 'bias' and val.ndim == 1:
            _set(params, (*owner, 'bias'), val)
            continue

        raise KeyError(f'unmapped reference checkpoint key: {key}')

    out = {'params': params}
    if batch_stats:
        out['batch_stats'] = batch_stats
    return out
