"""sed_tpu_torch log-mel frontend, its CUDA kernel's wrapper and the
wire dequant, against the JAX package.

Inputs come from numpy seeds and go through both packages.  Log-mel
tolerance: rtol 1e-4, atol 1e-3 dB (tests/test_ops.py's, fp32 sums in
another order).  The kernel itself is tested on the card by
tests/test_torch_cuda.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.config import AUDIO_8K, AUDIO_16K, AUDIO_32K
from sed_tpu.dsp import frontend as jax_fe
from sed_tpu.ops import wire as jax_wire
from sed_tpu.ops.logmel_kernel import fused_logmel as jax_fused_logmel
from sed_tpu_torch.dsp import frontend as fe
from sed_tpu_torch.ops import wire
from sed_tpu_torch.ops.logmel_kernel import fused_logmel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-3)
CFGS = pytest.mark.parametrize('cfg', [AUDIO_8K, AUDIO_16K, AUDIO_32K],
                               ids=['8k', '16k', '32k'])


def _wav(cfg, batch=2, seconds=1.0, seed=0):
    rng = np.random.RandomState(seed)
    return rng.uniform(-0.5, 0.5, (batch, int(cfg.sample_rate * seconds))
                       ).astype(np.float32)


@CFGS
def test_logmel_plain_matches_jax_frontend(cfg):
    wav = _wav(cfg)
    want = np.asarray(jax_fe.LogmelFrontend(cfg)(jnp.asarray(wav)))
    got = fe.logmel_plain(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape == (2, cfg.sample_rate // cfg.hop_size + 1,
                                       64)
    np.testing.assert_allclose(got, want, **TOL)


@CFGS
def test_logmel_plain_matches_pallas_kernel_interpret(cfg):
    wav = _wav(cfg, seed=1)
    want = np.asarray(jax_fused_logmel(jnp.asarray(wav), cfg, interpret=True))
    got = fe.logmel_plain(torch.from_numpy(wav), cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_logmel_plain_row_padding_case():
    """The Pallas kernel pads 3 x 51 rows to its 128-row tile and trims;
    the plain version needs no padding and gives the same rows."""
    cfg = AUDIO_16K
    wav = _wav(cfg, batch=3, seconds=0.5, seed=2)
    want = np.asarray(jax_fused_logmel(jnp.asarray(wav), cfg, tile_rows=128,
                                       interpret=True))
    got = fe.logmel_plain(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == (3, 51, 64)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('pad_mode', ['reflect', 'constant'])
def test_frame_signal_matches_jax(pad_mode):
    x = np.random.RandomState(3).standard_normal((2, 1000)).astype(np.float32)
    want = np.asarray(jax_fe.frame_signal(jnp.asarray(x), 256, 80,
                                          pad_mode=pad_mode))
    got = fe.frame_signal(torch.from_numpy(x), 256, 80,
                          pad_mode=pad_mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('top_db', [None, 30.0])
def test_power_to_db_matches_jax(top_db):
    x = np.random.RandomState(4).exponential(1e-3, (2, 50, 64)) \
        .astype(np.float32)
    x[0, :5] = 0.0                                  # hits the amin clamp
    want = np.asarray(jax_fe.power_to_db(jnp.asarray(x), top_db=top_db))
    got = fe.power_to_db(torch.from_numpy(x), top_db=top_db).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_logmel_cpu_tensor_is_plain_and_launches_nothing():
    cfg = AUDIO_16K
    wav = torch.from_numpy(_wav(cfg, seed=5))
    before = fused_logmel.launches
    got = fused_logmel(wav, cfg)
    assert fused_logmel.launches == before == 0
    torch.testing.assert_close(got, fe.logmel_plain(wav, cfg), rtol=0,
                               atol=0)


def test_fused_logmel_rejects_top_db():
    import dataclasses
    cfg = dataclasses.replace(AUDIO_16K, top_db=80.0)
    with pytest.raises(ValueError, match='top_db'):
        fused_logmel(torch.zeros(1, 16000), cfg)


def test_int16_wire_matches_jax_bit_exact():
    pcm = np.random.RandomState(6).randint(-32768, 32768, (3, 8000),
                                           dtype=np.int64).astype(np.int16)
    want = np.asarray(jax_wire.dequant_wire(jnp.asarray(pcm)))
    got = wire.dequant_wire(torch.from_numpy(pcm)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    f32 = want.copy()                               # float32 passes through
    np.testing.assert_array_equal(
        wire.dequant_wire(torch.from_numpy(f32)).numpy(), f32)


def test_uint8_wire_not_ported_raises():
    """A uint8 buffer without its decoded length is refused (its width
    cannot tell mu-law from qN), as is a width that is no wire's."""
    with pytest.raises(ValueError, match='samples'):
        wire.dequant_wire(torch.zeros(1, 80000, dtype=torch.uint8))
    with pytest.raises(ValueError, match='neither'):
        wire.dequant_wire(torch.zeros(1, 1234, dtype=torch.uint8), 80000)


_NO_JAX_SCRIPT = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax'):
            raise ImportError('blocked: ' + name)

sys.meta_path.insert(0, Block())
import numpy as np, torch
import sed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sed_tpu_torch.__path__,
                                               'sed_tpu_torch.')]
for name in names:
    importlib.import_module(name)
from sed_tpu_torch import config
from sed_tpu_torch.dsp.frontend import logmel_plain
out = logmel_plain(torch.zeros(2, 16000), config.AUDIO_16K)
assert out.shape == (2, 101, 64), out.shape
print(len(names), 'modules')
'''


def test_port_imports_and_runs_without_jax():
    """Every sed_tpu_torch module imports, and logmel_plain runs, in a
    process where jax, flax, optax and orbax cannot be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _NO_JAX_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 15, proc.stdout
