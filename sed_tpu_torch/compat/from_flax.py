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


# the reference's attention head is two 1x1 Conv1d, weights (O, I, 1);
# the port's are Linear, (O, I)
_CONV1D_HEAD = ('att_block.att.weight', 'att_block.cla.weight')


def reference_state_dict(state: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A port model's ``state_dict`` -> the reference's layout (the port's
    names, ``att_block.{att,cla}.weight`` as Conv1d (O, I, 1)), on the
    CPU: what ``sed_tpu.compat.torch_loader`` and the reference read."""
    out = {}
    for key, value in state.items():
        value = value.detach().to('cpu', copy=True)
        out[key] = value[:, :, None] if key in _CONV1D_HEAD else value
    return out


def port_state_dict(reference: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of ``reference_state_dict``."""
    return {key: value[:, :, 0] if key in _CONV1D_HEAD else value
            for key, value in reference.items()}


def load_variables(model: torch.nn.Module, variables: dict):
    """Load a flax variables tree into ``model`` (strict: every leaf and
    every model tensor must be matched)."""
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    return model


def _model_with(variables: dict, model_type: str, cfg,
                device) -> torch.nn.Module:
    from sed_tpu_torch.models.registry import get_model
    model = get_model(model_type, cfg)
    load_variables(model, variables)
    return model.to(torch.device(device)).eval()


def load_npz(path: str, model_type: str, cfg, device) -> torch.nn.Module:
    """A registry model with the weights of a ``sed_tpu`` .npz checkpoint,
    on ``device``, in eval mode."""
    return _model_with(npz_ckpt.load_variables_npz(path), model_type, cfg,
                       device)


def pth_variables(path: str) -> dict:
    """A reference ``.pth`` checkpoint -> flax variables tree.  Takes the
    training layout ``{'iteration', 'model', 'optimizer'}`` and a bare
    state_dict; ``module.`` prefixes are stripped by the name map."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    state = obj['model'] if isinstance(obj, dict) and 'model' in obj \
        else obj
    return torch_loader.state_dict_to_variables(
        {k: v.numpy() for k, v in state.items()})


def load_checkpoint(path: str, model_type: str, cfg,
                    device) -> torch.nn.Module:
    """A registry model with the weights of a ``sed_tpu`` ``.npz`` or a
    reference ``.pth`` checkpoint, on ``device``, in eval mode."""
    if os.path.isdir(path):
        raise ValueError(
            f'{path} is an Orbax checkpoint directory, which needs JAX to '
            'read; export it once with sed_tpu.utils.npz_ckpt.'
            'save_variables_npz and pass the .npz')
    if path.endswith('.npz'):
        return load_npz(path, model_type, cfg, device)
    if path.endswith('.pth'):
        return _model_with(pth_variables(path), model_type, cfg, device)
    raise ValueError(f'{path}: a checkpoint is a sed_tpu .npz or a '
                     'reference .pth')
