"""The reference's ``.pth`` state-dict names -> flax variable trees (a
copy of ``sed_tpu/compat/torch_loader.py:state_dict_to_variables`` and
its name map).

The reference saves ``{'iteration', 'model': model.module.state_dict(),
'optimizer': ...}`` via ``torch.save`` (``pytorch/main_strong.py:326-334``).
The port reads the file with ``torch.load`` (``compat/from_flax.py``) and
maps the state dict's keys here onto the flax-layout tree that
``from_flax`` turns into a PyTorch ``state_dict`` of its own models.
Only the families the port has (``models/registry.py``: CNN, CNN +
BiGRU, CNN + MultiHead) are mapped; the Conformer / ESPnet encoder,
baseline CNN and VGGish branches of ``sed_tpu``'s map are not copied:
their keys raise.
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


def _set(tree: dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


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
        if (parts[0] == 'encoder' or parts[:2] == ['cnn', 'cnn']
                or 'vggish' in parts):
            raise KeyError(f'{key}: a model family the port does not have')

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

