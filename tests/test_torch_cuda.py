"""sed_tpu_torch on the card: the CUDA log-mel kernel against its plain
PyTorch version, and the CUDA engine against the CPU engine.

These tests need an NVIDIA GPU with nvcc (the kernel has no CPU mode)
and skip elsewhere.  They import no JAX or flax, so they run on a card
machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Log-mel tolerance: rtol 1e-4, atol 1e-3 dB (fp32 sums in another order).
"""

import os
import sys

import numpy as np
import pytest
import torch

from sed_tpu_torch._host import config
from sed_tpu_torch.compat.from_flax import load_npz
from sed_tpu_torch.dsp.frontend import logmel_plain
from sed_tpu_torch.ops.logmel_kernel import fused_logmel
from sed_tpu_torch.serve import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
MODEL = 'Cnn_9layers_Gru_FrameAtt'
TOL = dict(rtol=1e-4, atol=1e-3)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    engine.disable_tf32()
    return torch.device('cuda')


@pytest.mark.parametrize('cfg', [config.AUDIO_8K, config.AUDIO_16K,
                                 config.AUDIO_32K], ids=['8k', '16k', '32k'])
def test_kernel_matches_plain(device, cfg):
    """A frame count that no 64-frame tile divides, a near-silent row and
    a half digitally silent row (the amin clamp)."""
    rng = np.random.RandomState(7)
    wav = rng.uniform(-0.5, 0.5, (3, int(cfg.sample_rate * 1.13))) \
        .astype(np.float32)
    wav[1] *= 1e-4
    wav[2, :wav.shape[1] // 2] = 0.0
    x = torch.from_numpy(wav).to(device)
    before = fused_logmel.launches
    got = fused_logmel(x, cfg)
    torch.cuda.synchronize()
    assert fused_logmel.launches == before + 1
    assert got.shape[1] % 64 != 0
    torch.testing.assert_close(got, logmel_plain(x, cfg), **TOL)


def test_kernel_rejects_what_it_does_not_take(device):
    cfg = config.AUDIO_16K
    with pytest.raises(ValueError, match='float32'):
        fused_logmel(torch.zeros(2, 16000, dtype=torch.float64,
                                 device=device), cfg)
    with pytest.raises(ValueError, match='contiguous'):
        fused_logmel(torch.zeros(16000, 2, device=device).t(), cfg)


def test_cuda_engine_matches_cpu_engine(device):
    """The main path on the card launches the kernel and gives the CPU
    engine's events and XML on 8 int16 bench-corpus clips."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from bench_corpus import make_clips
    cfg = config.AUDIO_16K
    clips = make_clips(8, cfg.sample_rate, seconds=5, seed=0)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
    cpu = engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, 'cpu'), cfg,
                                    'cpu', batch_size=8)
    gpu = engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, device), cfg,
                                    device, batch_size=8)
    before = fused_logmel.launches
    assert gpu.predict_clips(pcm) == cpu.predict_clips(pcm)
    assert fused_logmel.launches > before


def test_cuda_engine_refuses_tf32(device):
    cfg = config.AUDIO_16K
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match='TF32'):
            engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, 'cpu'), cfg,
                                      device)
    finally:
        engine.disable_tf32()
