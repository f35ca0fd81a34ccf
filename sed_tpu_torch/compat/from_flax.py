"""flax variables -> PyTorch ``state_dict`` for the port's models.

The input is the JAX package's variables tree as nested numpy dicts
(``{'params': ..., 'batch_stats': ...}``, what
``utils/npz_ckpt.load_variables_npz`` returns).  Layout changes:

* conv kernel HWIO -> OIHW;
* Dense kernel (in, out) -> Linear weight (out, in);
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  (plus ``num_batches_tracked``, which eval ignores);
* ``gru/{fw,bw}/{w_ih,w_hh,b_ih,b_hh}`` -> ``gru.weight_ih_l0[_reverse]``
  and the rest; ``sed_tpu`` already stores torch's (r, z, n) gate order.

* LayerNorm scale/bias -> weight/bias; the conv module's depthwise kernel
  (K, 1, C) -> ``Conv1d`` weight (C, 1, K); its ``pw1`` / ``pw2`` Dense
  kernels -> Linear; ``r_w_bias`` / ``r_r_bias`` verbatim.

``variables_from_model`` maps a port model back onto a flax tree (what
``utils/npz_ckpt.save_variables_npz`` writes).
``reference_state_dict`` writes a port ``state_dict`` in the reference's
layout (what the port's trainer saves) and ``port_state_dict`` reads it
back.  ``load_checkpoint`` also reads the reference's ``.pth`` checkpoints:
``torch.load`` gives the tensors, ``compat/torch_loader.py`` (numpy
only, a copy of ``sed_tpu``'s) maps the reference's names onto a flax
tree, and the tree goes through the same map as a ``.npz``.  Orbax checkpoint directories
need JAX to read and are refused with the export to use.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

from sed_tpu_torch.compat import torch_loader
from sed_tpu_torch.utils import npz_ckpt

_BN = {'scale': 'weight', 'bias': 'bias'}
_STATS = {'mean': 'running_mean', 'var': 'running_var'}
_GRU = {'w_ih': 'weight_ih_l0', 'w_hh': 'weight_hh_l0',
        'b_ih': 'bias_ih_l0', 'b_hh': 'bias_hh_l0'}


def _flatten(tree: dict, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def torch_key(collection: str, path: tuple, leaf: np.ndarray):
    """(torch state_dict key, tensor) for one flax leaf."""
    *mods, name = path
    if collection == 'batch_stats':
        return '.'.join(mods + [_STATS[name]]), leaf
    if mods and mods[0] == 'gru':                 # gru/{fw,bw}/<name>
        suffix = '_reverse' if mods[1] == 'bw' else ''
        return f'gru.{_GRU[name]}{suffix}', leaf
    if name == 'kernel':
        if leaf.ndim == 4:                        # conv HWIO -> OIHW
            return '.'.join(mods + ['weight']), leaf.transpose(3, 2, 0, 1)
        if leaf.ndim == 3:          # depthwise (K, 1, C) -> Conv1d (C, 1, K)
            return '.'.join(mods + ['weight']), leaf.transpose(2, 1, 0)
        return '.'.join(mods + ['weight']), leaf.T  # Dense (in,out)->(out,in)
    return '.'.join(mods + [_BN.get(name, name)]), leaf


def state_dict_from_variables(variables: dict) -> Dict[str, torch.Tensor]:
    """Map a flax variables tree onto the port's state_dict keys."""
    state: Dict[str, torch.Tensor] = {}
    for collection in ('params', 'batch_stats'):
        for path, leaf in _flatten(variables.get(collection, {})).items():
            key, value = torch_key(collection, path, leaf)
            if key in state:
                raise ValueError(f'two flax leaves map to {key}')
            state[key] = torch.from_numpy(np.array(value, np.float32))
            if key.endswith('.running_mean'):
                state[key[:-len('running_mean')] + 'num_batches_tracked'] = \
                    torch.tensor(0, dtype=torch.long)
    return state


_BN_BACK = {'weight': 'scale', 'bias': 'bias'}
_STATS_BACK = {v: k for k, v in _STATS.items()}
_GRU_BACK = {v: k for k, v in _GRU.items()}


def flax_leaf(key: str, value: np.ndarray):
    """(collection, flax path, leaf) for one port ``state_dict`` tensor:
    the inverse of ``torch_key``."""
    *mods, name = key.split('.')
    if name in _STATS_BACK:
        return 'batch_stats', (*mods, _STATS_BACK[name]), value
    if mods == ['gru']:                           # gru.<name>[_reverse]
        base = name.removesuffix('_reverse')
        return 'params', ('gru', 'fw' if base == name else 'bw',
                          _GRU_BACK[base]), value
    if name == 'weight' and value.ndim >= 2:
        if value.ndim == 4:                       # conv OIHW -> HWIO
            return 'params', (*mods, 'kernel'), value.transpose(2, 3, 1, 0)
        if value.ndim == 3:         # Conv1d (C, 1, K) -> depthwise (K, 1, C)
            return 'params', (*mods, 'kernel'), value.transpose(2, 1, 0)
        return 'params', (*mods, 'kernel'), value.T  # Linear -> Dense
    return 'params', (*mods, _BN_BACK.get(name, name)), value


def variables_from_model(model: torch.nn.Module) -> dict:
    """A port model's flax variables tree (nested numpy float32 dicts):
    the inverse of ``state_dict_from_variables``, what
    ``utils/npz_ckpt.save_variables_npz`` writes and ``sed_tpu``
    reads.  ``num_batches_tracked`` has no flax leaf."""
    variables: dict = {}
    for key, tensor in model.state_dict().items():
        if key.endswith('num_batches_tracked'):
            continue
        collection, path, leaf = flax_leaf(
            key, tensor.detach().to('cpu', torch.float32).numpy())
        node = variables.setdefault(collection, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if path[-1] in node:
            raise ValueError(f'two tensors map to {collection}/{path}')
        node[path[-1]] = np.ascontiguousarray(leaf)
    return variables


# ---------------------------------------------------------------------------
# the port's state_dict <-> the reference's layout
# ---------------------------------------------------------------------------

# (port key prefix, reference key prefix); ``#`` stands for an index.  The
# reference builds its encoder package out of ``nn.Sequential``s, so its
# keys are positions (``compat/torch_loader.py`` has the way back onto
# the flax names, which are the port's); its pointwise and depthwise
# convs sit in wrappers (``.conv``), and its stripped VGGish is
# ``Sequential(features)``, hence ``vggish.0.<n>``.  A key no row matches
# is the same in both layouts.
_RENAMES = (
    ('encoder.input_layer.linear.', 'encoder.input_layer.0.'),
    ('encoder.input_layer.norm.', 'encoder.input_layer.1.'),
    ('encoder.input_layer.conv1.', 'encoder.input_layer.conv.0.'),
    ('encoder.input_layer.conv2.', 'encoder.input_layer.conv.2.'),
    ('encoder.input_layer.out.', 'encoder.input_layer.out.0.'),
    *((f'encoder.block#.{ffn}.{ours}.',
       f'encoder.conformer_blocks.#.{ffn}.feed_forward_module.{theirs}.')
      for ffn in ('ffn1', 'ffn2')
      for ours, theirs in (('norm', 0), ('w_1', 1), ('w_2', 4))),
    *((f'encoder.block#.conv.{ours}.',
       f'encoder.conformer_blocks.#.conv.conv.{theirs}.')
      for ours, theirs in (('norm', '0'), ('pw1', '1.conv'),
                           ('dw', '3.conv'), ('bn', '5'),
                           ('pw2', '8.conv'))),
    ('encoder.block#.', 'encoder.conformer_blocks.#.'),   # mhsa, norm
    ('encoder.layer#.', 'encoder.encoders.#.'),
    ('cnn.bn#.', 'cnn.cnn.batchnorm#.'),
    ('cnn.', 'cnn.cnn.'),                                 # conv#, glu#, cg#
    *((f'vggish.conv{i}.', f'vggish.0.{n}.')
      for i, n in enumerate((0, 3, 6, 8, 11, 13))),
)


def _compile(rows, src: int):
    return [(re.compile('^' + re.escape(row[src]).replace('\\#',
                                                          r'(\d+)')),
             row[1 - src].replace('#', r'\1')) for row in rows]


_TO_REFERENCE = _compile(_RENAMES, 0)
_TO_PORT = _compile(_RENAMES, 1)

# 1x1 ``Conv1d`` weights (O, I, 1) in the reference that are ``Linear``
# (O, I) in the port: the attention head and the conv module's pointwise
# convs (reference keys)
_CONV1D_AS_LINEAR = re.compile(
    r'^(att_block\.(att|cla)|encoder\.conformer_blocks\.\d+\.conv\.conv\.'
    r'(1|8)\.conv)\.weight$')


def _rename(key: str, table) -> str:
    for pattern, repl in table:
        new, n = pattern.subn(repl, key, count=1)
        if n:
            return new
    return key


def reference_state_dict(state: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A port model's ``state_dict`` -> the reference's layout, on the
    CPU: what ``sed_tpu.compat.torch_loader`` and the reference read.
    For the CNN, GRU and MultiHead families the names are the port's own;
    the encoder package, the baseline CNN and VGGish get the reference's
    ``nn.Sequential`` positions; ``att_block.{att,cla}`` and the conv
    module's pointwise weights become Conv1d (O, I, 1)."""
    out = {}
    for key, value in state.items():
        value = value.detach().to('cpu', copy=True)
        key = _rename(key, _TO_REFERENCE)
        out[key] = value[:, :, None] if _CONV1D_AS_LINEAR.match(key) \
            else value
    return out


def port_state_dict(reference: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of ``reference_state_dict``."""
    return {_rename(key, _TO_PORT):
            value[:, :, 0] if _CONV1D_AS_LINEAR.match(key) else value
            for key, value in reference.items()}


def load_variables(model: torch.nn.Module, variables: dict):
    """Load a flax variables tree into ``model`` (strict: every leaf and
    every model tensor must be matched)."""
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    return model


def _model_with(variables: dict, model_type: str, cfg, device,
                drop_unused: bool = False, feature_type: str = 'logmel',
                **model_kwargs) -> torch.nn.Module:
    from sed_tpu_torch.models.registry import get_model
    model = get_model(model_type, cfg, feature_type=feature_type,
                      **model_kwargs)
    if drop_unused:
        # tensors the reference's module holds and its forward never
        # uses (``reference_unused`` of the model class); flax ignores
        # such leaves, a strict load would not
        variables = {
            collection: {k: v for k, v in tree.items()
                         if k not in model.reference_unused}
            for collection, tree in variables.items()}
    load_variables(model, variables)
    return model.to(torch.device(device)).eval()


def load_npz(path: str, model_type: str, cfg, device,
             feature_type: str = 'logmel', **model_kwargs) -> torch.nn.Module:
    """A registry model with the weights of a ``sed_tpu`` .npz checkpoint,
    on ``device``, in eval mode; ``model_kwargs`` (``compute_dtype``) go
    to ``get_model``."""
    return _model_with(npz_ckpt.load_variables_npz(path), model_type, cfg,
                       device, feature_type=feature_type, **model_kwargs)


def pth_variables(path: str) -> dict:
    """A reference ``.pth`` checkpoint -> flax variables tree.  Takes the
    training layout ``{'iteration', 'model', 'optimizer'}`` and a bare
    state_dict; ``module.`` prefixes are stripped by the name map."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    state = obj['model'] if isinstance(obj, dict) and 'model' in obj \
        else obj
    return torch_loader.state_dict_to_variables(
        {k: v.numpy() for k, v in state.items()})


def load_checkpoint(path: str, model_type: str, cfg, device,
                    feature_type: str = 'logmel',
                    **model_kwargs) -> torch.nn.Module:
    """A registry model with the weights of a ``sed_tpu`` ``.npz`` or a
    reference ``.pth`` checkpoint, on ``device``, in eval mode.  A
    ``feature_type='gamma'`` model has the same tensors as a log-mel one
    (the reference's ``gamma_extractor.`` tensors are skipped by the name
    map).  ``model_kwargs`` as ``load_npz``'s."""
    if os.path.isdir(path):
        raise ValueError(
            f'{path} is an Orbax checkpoint directory, which needs JAX to '
            'read; export it once with sed_tpu.utils.npz_ckpt.'
            'save_variables_npz and pass the .npz')
    if path.endswith('.npz'):
        return load_npz(path, model_type, cfg, device, feature_type,
                        **model_kwargs)
    if path.endswith('.pth'):
        return _model_with(pth_variables(path), model_type, cfg, device,
                           drop_unused=True, feature_type=feature_type,
                           **model_kwargs)
    raise ValueError(f'{path}: a checkpoint is a sed_tpu .npz or a '
                     'reference .pth')
