"""``sed_tpu``'s fresh initialisation of ``Cnn_9layers_Gru_FrameAtt``, drawn
in numpy.

``sed_tpu``'s trainer starts from ``model.init({'params':
jax.random.PRNGKey(0)}, ...)`` (``sed_tpu/cli/main_strong.py:128``).
The port's own fresh draw (``models/blocks.init_weights``) has the same
distributions but other values: torch's generator is not JAX's.  This
module draws ``sed_tpu``'s values without JAX, so that a run of the port
can start where ``sed_tpu``'s began (``tools/torch_make_bench_checkpoint.py``):

* JAX's PRNG: threefry-2x32 over a 64-bit counter, with
  ``jax_threefry_partitionable`` on (its default): random bits are the
  XOR of the two output words, ``split`` hashes the counters 0..n-1;
  ``fold_in(key, d)`` hashes the pair (0, d);
* flax's keys: a parameter's key is the root key folded with the first
  four bytes (big-endian) of the SHA-1 of its module path and its rank
  among the module's parameters (``flax.core.scope.LazyRng``);
* the initialisers of ``sed_tpu/models/blocks.py``: Xavier-uniform for the
  convolutions and the attention head, per-gate uniform for the GRU
  input weights, uniform r/z gates and an orthogonal n gate for its
  recurrent weights; ones, zeros and unit variances elsewhere.

Uniform draws are JAX's bit for bit; the orthogonal block comes from
``scipy.special.erfinv`` and numpy's QR where JAX uses XLA's, and agrees
to float32 rounding.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` (two uint32), as JAX computes it."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over='ignore'):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed below 2**32."""
    return np.array([0, seed], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    a, b = threefry2x32(key, np.uint32([0]), np.uint32([data]))
    return np.array([a[0], b[0]], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    a, b = threefry2x32(key, np.zeros(num, np.uint32),
                        np.arange(num, dtype=np.uint32))
    return np.stack([a, b], axis=1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element (the counter's high word is 0 below
    2**32 elements)."""
    n = int(np.prod(shape))
    a, b = threefry2x32(key, np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))
    return (a ^ b).reshape(shape)


def uniform(key: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses the scale and shift into one FMA (a single rounding)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2) erfinv(u), u uniform in
    (-1, 1)."""
    from scipy.special import erfinv
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv(u.astype(np.float64))
            ).astype(np.float32)


def orthogonal(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.orthogonal(key, n)``: Q of a normal matrix's QR, each
    column's sign that of R's diagonal."""
    q, r = np.linalg.qr(normal(key, (n, n)).astype(np.float64))
    return (q * np.sign(np.diag(r))[None, :]).astype(np.float32)


def param_key(root: np.ndarray, path: Tuple[str, ...], rank: int
              ) -> np.ndarray:
    """The key flax gives the ``rank``-th parameter (from 1) of the
    module at ``path``."""
    m = hashlib.sha1()
    for part in path:
        m.update(part.encode('utf-8'))
    m.update(rank.to_bytes((rank.bit_length() + 7) // 8, 'big'))
    return fold_in(root, int.from_bytes(m.digest()[:4], 'big'))


def _xavier_uniform(key, shape) -> np.ndarray:
    receptive = int(np.prod(shape[:-2]))
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    return uniform(key, shape, -1.0) * np.sqrt(np.float32(3) * variance)


def _gru_hh(key, shape) -> np.ndarray:
    h = shape[1]
    k1, k2 = split(key)
    bound = np.sqrt(3.0 / h)
    return np.concatenate([uniform(k1, (2 * h, h), -bound, bound),
                           orthogonal(k2, h)])


def gru_frameatt_variables(template: dict, seed: int = 0) -> dict:
    """``sed_tpu``'s ``model.init`` of ``Cnn_9layers_Gru_FrameAtt`` under
    ``PRNGKey(seed)``, as a flax variables tree of the shapes of
    ``template`` (a tree of this model, e.g.
    ``compat/from_flax.variables_from_model`` of a port model)."""
    root = prng_key(seed)

    def draw(path: tuple, leaf: np.ndarray) -> np.ndarray:
        *mods, name = path
        shape = leaf.shape
        if path[0] == 'batch_stats':
            return np.full(shape, 1.0 if name == 'var' else 0.0, np.float32)
        mods = tuple(mods[1:])
        if name in ('scale', 'bias', 'b_ih', 'b_hh'):
            return np.full(shape, 1.0 if name == 'scale' else 0.0,
                           np.float32)
        if name == 'kernel':
            return _xavier_uniform(param_key(root, mods, 1), shape)
        if name == 'w_ih':
            bound = np.sqrt(3.0 / shape[1])
            return uniform(param_key(root, mods, 1), shape, -bound, bound)
        if name == 'w_hh':
            return _gru_hh(param_key(root, mods, 2), shape)
        raise ValueError(f'{"/".join(path)}: not a leaf of '
                         'Cnn_9layers_Gru_FrameAtt')

    def walk(tree: dict, path: tuple) -> dict:
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else draw(path + (k,), np.asarray(v))
                for k, v in tree.items()}

    return walk(template, ())
