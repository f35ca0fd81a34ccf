"""Training checkpoints in the reference's own format (counterpart of
``sed_tpu/train/checkpoint.py``).

Each checkpoint is ``torch.save({'iteration', 'model', 'optimizer'})``
(``pytorch/main_strong.py:326-334``) with ``model`` in the reference's
state-dict layout (``compat.from_flax.reference_state_dict``), so
``sed_tpu.compat.torch_loader``, the reference, and the port's
``compat.from_flax.load_checkpoint`` all read it; ``optimizer`` is the
``AmsGrad`` state for resume.  Best checkpoints form a step-tagged
lineage, ``<ckpt_dir>/iter_<N>.pth`` plus a ``BEST`` marker, so
``--resume_iteration N`` restores the checkpoint *at* N.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from sed_tpu_torch.compat.from_flax import (port_state_dict,
                                            reference_state_dict)

_ITER = re.compile(r'^iter_(\d+)\.pth$')


def is_orbax_checkpoint(path: str) -> bool:
    """True when ``path`` holds a saved Orbax checkpoint (``sed_tpu``'s
    format, which needs JAX to read): the metadata files Orbax writes at
    a checkpoint's root."""
    return any(os.path.exists(os.path.join(path, name))
               for name in ('_CHECKPOINT_METADATA', '_METADATA',
                            'manifest.ocdbt'))


def saved_iterations(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_ITER.match,
                                               os.listdir(ckpt_dir)) if m)


def save_checkpoint(path: str, state) -> None:
    """Save a ``TrainState`` to ``path`` (a ``.pth`` file)."""
    torch.save({'iteration': state.step,
                'model': reference_state_dict(state.model.state_dict()),
                'optimizer': state.optimizer.state_dict()}, path)


def save_best_checkpoint(ckpt_dir: str, state) -> str:
    """Save ``ckpt_dir/iter_<step>.pth`` and point ``BEST`` at it."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f'iter_{state.step}.pth')
    save_checkpoint(path, state)
    with open(os.path.join(ckpt_dir, 'BEST'), 'w') as f:
        f.write(str(state.step))
    return path


def best_checkpoint_path(ckpt_dir: str) -> Optional[str]:
    """The ``BEST`` marker's checkpoint, else the highest ``iter_*.pth``,
    else None."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    marker = os.path.join(ckpt_dir, 'BEST')
    if os.path.isfile(marker):
        with open(marker) as f:
            return os.path.join(ckpt_dir, f'iter_{int(f.read().strip())}.pth')
    have = saved_iterations(ckpt_dir)
    return os.path.join(ckpt_dir, f'iter_{have[-1]}.pth') if have else None


def resume_checkpoint_path(ckpt_dir: str, iteration: int) -> str:
    """The checkpoint saved at exactly ``iteration`` (the
    ``--resume_iteration N`` contract, ``pytorch/main_strong.py:205-213``);
    raises with the saved iterations when N was never saved."""
    path = os.path.join(os.path.abspath(ckpt_dir), f'iter_{iteration}.pth')
    if os.path.isfile(path):
        return path
    raise FileNotFoundError(
        f'no checkpoint at iteration {iteration} in {ckpt_dir}; '
        f'saved iterations: {saved_iterations(ckpt_dir)}')


def restore_checkpoint(path: str, state):
    """Load a checkpoint written by ``save_checkpoint`` into ``state``'s
    model (parameters and BatchNorm buffers) and optimizer; returns
    ``state``."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    state.model.load_state_dict(port_state_dict(obj['model']), strict=True)
    state.optimizer.load_state_dict(obj['optimizer'])
    if state.step != int(obj['iteration']):
        raise ValueError(f'{path}: iteration {obj["iteration"]} but the '
                         f'optimizer state has taken {state.step} steps')
    return state
