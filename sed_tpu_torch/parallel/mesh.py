"""Device meshes, batch shards and FSDP (counterpart of
``sed_tpu/parallel/mesh.py``).

``sed_tpu`` shards a global batch over a ``('data',)`` mesh (or
``('data', 'model')`` with FSDP-style parameter sharding) inside one
JAX program.  Here each rank is one process of a ``torch.distributed``
group: the mesh is ``torch.distributed.device_mesh``'s, a rank holds its
share of the batch's rows (``shard_batch``), the train step averages
gradients over the ``data`` axis' group (``train/step.py``), and
``fsdp_shard`` shards the larger parameters over the ``model`` axis with
FSDP2.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from sed_tpu_torch.parallel import distributed


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ('data',),
              shape: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over the default group's ``n_devices`` ranks (all
    of them by default), one device each.

    With the default ``('data',)`` axis this is pure data parallelism;
    ``axis_names=('data', 'model')`` and a 2-D ``shape`` give the hybrid
    data x model mesh.  The mesh's devices are CUDA under NCCL and the CPU
    under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if n_devices is None:
        n_devices = distributed.world_size()
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f'mesh shape {tuple(shape)} does not hold '
                         f'{n_devices} devices')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def shard_batch(batch: dict, mesh=None, axis: str = 'data',
                device='cpu') -> dict:
    """This rank's share of a GLOBAL batch dict on ``device``: the
    ``index``-th of ``count`` equal, contiguous slices of dim 0 of every
    array along ``axis`` (ranks that differ only along another axis get
    the same rows).  Numpy arrays and tensors are taken."""
    if mesh is None:
        index, count = distributed.rank(), distributed.world_size()
    else:
        index, count = mesh.get_local_rank(axis), mesh[axis].size()
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % count:
            raise ValueError(f'{k}: batch of {n} does not divide over '
                             f'{count} ranks of axis {axis!r}')
        share = n // count
        v = v[index * share:(index + 1) * share]
        out[k] = (torch.from_numpy(np.ascontiguousarray(v))
                  if isinstance(v, np.ndarray) else v).to(device)
    return out


def fsdp_shard(model: nn.Module, mesh, axis: str = 'model',
               min_size: int = 65536) -> list:
    """Shard the larger parameters of ``model`` over ``axis`` of ``mesh``
    (counterpart of ``fsdp_shardings``); returns the names of the
    modules wrapped.

    Each module that directly holds a parameter of at least ``min_size``
    elements is wrapped by FSDP2's ``fully_shard`` on the ``axis``
    sub-mesh; every other parameter stays a replicated tensor.  FSDP2
    shards dim 0 of each parameter of a module it wraps (the module's
    smaller parameters with it), where ``sed_tpu`` shards the largest
    divisible dim of each large leaf: a difference of storage layout,
    not of results.  The forward all-gathers a wrapped module's
    parameters, the backward reduce-scatters their gradients (averaged
    over ``axis``), and the AMSGrad state follows the shards
    (``train/state.AmsGrad``).  Ranks along ``axis`` hold the same rows,
    so the train step averages over the ``data`` axis alone.
    """
    from torch.distributed.fsdp import fully_shard
    sub = mesh[axis]
    wrapped = [name for name, m in model.named_modules()
               if any(p.numel() >= min_size
                      for p in m.parameters(recurse=False))]
    for name in reversed(wrapped):            # children before parents
        fully_shard(model.get_submodule(name), mesh=sub)
    return wrapped
