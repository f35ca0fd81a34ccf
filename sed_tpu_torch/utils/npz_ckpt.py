"""Single-file .npz variable checkpoints.

Orbax directories are the training checkpoint format; this flat format
exists for small repo-committable artifacts (the trained bench
checkpoint) — float16-cast leaves, '/'-joined tree keys, one compressed
file.

A copy of ``sed_tpu/utils/npz_ckpt.py``: the port keeps its own host
modules and imports nothing of the JAX package.  A port model's tree
comes from ``compat/from_flax.variables_from_model``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _flatten(tree: dict, prefix: str = '') -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f'{prefix}/{k}' if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_variables_npz(path: str, variables: dict,
                       dtype=np.float16) -> None:
    """Save a flax variables tree ({'params', 'batch_stats', ...})."""
    flat = _flatten(variables)
    cast = {k: (v.astype(dtype) if v.dtype == np.float32 else v)
            for k, v in flat.items()}
    np.savez_compressed(path, **cast)


def load_variables_npz(path: str) -> dict:
    """Load back to a nested float32 tree."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            v = data[key]
            if v.dtype == np.float16:
                v = v.astype(np.float32)
            node = out
            parts = key.split('/')
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out
