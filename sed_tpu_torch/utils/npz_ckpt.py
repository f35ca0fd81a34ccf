"""Single-file .npz variable checkpoints.

Orbax directories are the training checkpoint format; this flat format
exists for small repo-committable artifacts (the trained bench
checkpoint) — float16-cast leaves, '/'-joined tree keys, one compressed
file.

A copy of the reader of ``sed_tpu/utils/npz_ckpt.py`` (the port writes
no checkpoints): the port keeps its own host modules and imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np


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
