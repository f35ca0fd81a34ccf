"""sed_tpu_torch on the card: the CUDA log-mel kernel against its plain
PyTorch version, and the CUDA engine against the CPU engine.

These tests need an NVIDIA GPU with nvcc (the kernel has no CPU mode)
and skip elsewhere.  They import no JAX or flax, so they run on a card
machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Log-mel tolerance: rtol 1e-4, atol 1e-3 dB (fp32 sums in another order;
the kernel's DFT is fp64, its mel product 3xTF32).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from sed_tpu_torch._host import config
from sed_tpu_torch.compat.from_flax import load_npz
from sed_tpu_torch.dsp import frontend as fe
from sed_tpu_torch.dsp.frontend import logmel_plain
from sed_tpu_torch.ops.logmel_kernel import fused_logmel
from sed_tpu_torch.serve import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
MODEL = 'Cnn_9layers_Gru_FrameAtt'
TOL = dict(rtol=1e-4, atol=1e-3)

CFGS = pytest.mark.parametrize('cfg', [config.AUDIO_8K, config.AUDIO_16K,
                                        config.AUDIO_32K],
                               ids=['8k', '16k', '32k'])

pytestmark = pytest.mark.cuda


def _rows(cfg, batch: int, seconds: float, seed: int) -> np.ndarray:
    """-0.5..0.5 uniform clips; from the second on: a 1e-4-level clip, a
    half digitally silent clip (the amin clamp), a full-scale +-1.0 clip."""
    rng = np.random.RandomState(seed)
    wav = rng.uniform(-0.5, 0.5, (batch, int(cfg.sample_rate * seconds)))
    n = wav.shape[1]
    if batch > 1:
        wav[1] *= 1e-4 / np.sqrt(np.mean(wav[1] ** 2))
    if batch > 2:
        wav[2, :n // 2] = 0.0
    if batch > 3:
        wav[3] = np.where(wav[3] < 0, -1.0, 1.0)
    return wav.astype(np.float32)


def _logmel_float64(x: torch.Tensor, cfg) -> torch.Tensor:
    """The plain version's function in float64, on the same fp32
    matrices."""
    stft_mat, mel_mat = fe.frontend_matrices(cfg, x.device)
    spec = fe.spectrogram(x.double(), stft_mat.double(), cfg.hop_size,
                          center=cfg.center, pad_mode=cfg.pad_mode)
    return fe.power_to_db(spec @ mel_mat.double(), ref=cfg.ref,
                          amin=cfg.amin)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    engine.disable_tf32()
    return torch.device('cuda')


@CFGS
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


@CFGS
@pytest.mark.parametrize('batch', [1, 33])
def test_kernel_matches_plain_at_batch(device, cfg, batch):
    """Batch 1, and batch 33 of 6 s clips: more tiles than the card has
    SMs (33 x 10 64-frame tiles)."""
    x = torch.from_numpy(_rows(cfg, batch, 6.0, seed=batch)).to(device)
    got = fused_logmel(x, cfg)
    want = logmel_plain(x, cfg)
    torch.cuda.synchronize()
    print(f'{cfg.name} batch {batch}: max |kernel - plain| = '
          f'{(got - want).abs().max().item()!r} dB')
    assert got.shape == (batch, 601, 64)
    torch.testing.assert_close(got, want, **TOL)


@CFGS
def test_kernel_and_plain_against_float64(device, cfg):
    """Loud, 1e-4-level, half silent and full-scale clips: the kernel and
    the plain version each held against a float64 evaluation of the same
    matrices."""
    x = torch.from_numpy(_rows(cfg, 4, 2.0, seed=11)).to(device)
    ref = _logmel_float64(x, cfg)
    got = fused_logmel(x, cfg).double()
    plain = logmel_plain(x, cfg).double()
    k_err = (got - ref).abs().amax(dim=(1, 2)).tolist()
    p_err = (plain - ref).abs().amax(dim=(1, 2)).tolist()
    print(f'{cfg.name} max |. - float64| dB per clip (loud, 1e-4, half '
          f'silent, full scale): kernel {k_err}, plain {p_err}')
    torch.testing.assert_close(got, ref, **TOL)
    torch.testing.assert_close(plain, ref, **TOL)


@CFGS
def test_kernel_nyquist_bin(device, cfg):
    """With fmax past sr/2 the top mel filter weighs bin n_fft/2, which
    the kernel carries in the slot of sine 0."""
    wide = dataclasses.replace(cfg, fmax=int(cfg.sample_rate * 0.6))
    wav = _rows(cfg, 2, 1.0, seed=5)
    wav[0] += 0.4 * (-1.0) ** np.arange(wav.shape[1])    # a Nyquist tone
    x = torch.from_numpy(wav).to(device)
    assert fe.frontend_matrices(wide, device)[1][-1].abs().max() > 0
    torch.testing.assert_close(fused_logmel(x, wide), logmel_plain(x, wide),
                               **TOL)


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
