"""flax variables -> PyTorch ``state_dict`` for the port's models.

The input is the JAX package's variables tree as nested numpy dicts
(``{'params': ..., 'batch_stats': ...}``, what
``sed_tpu.utils.npz_ckpt.load_variables_npz`` returns).  Layout changes:

* conv kernel HWIO -> OIHW;
* Dense kernel (in, out) -> Linear weight (out, in);
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  (plus ``num_batches_tracked``, which eval ignores);
* ``gru/{fw,bw}/{w_ih,w_hh,b_ih,b_hh}`` -> ``gru.weight_ih_l0[_reverse]``
  and the rest; ``sed_tpu`` already stores torch's (r, z, n) gate order.

Orbax checkpoint directories need JAX to read and are not handled here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sed_tpu_torch._host import npz_ckpt

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


def load_variables(model: torch.nn.Module, variables: dict):
    """Load a flax variables tree into ``model`` (strict: every leaf and
    every model tensor must be matched)."""
    model.load_state_dict(state_dict_from_variables(variables), strict=True)
    return model


def load_npz(path: str, model_type: str, cfg, device) -> torch.nn.Module:
    """A registry model with the weights of a ``sed_tpu`` .npz checkpoint,
    on ``device``, in eval mode."""
    from sed_tpu_torch.models.registry import get_model
    model = get_model(model_type, cfg)
    load_variables(model, npz_ckpt.load_variables_npz(path))
    return model.to(torch.device(device)).eval()
