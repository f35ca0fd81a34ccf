"""The CUDA log-mel kernel's arithmetic, emulated on the CPU.

``csrc/logmel.cu`` runs the DFT on the fp64 tensor cores and the mel
product on the TF32 tensor cores in three passes (3xTF32), against
operands that ``sed_tpu_torch/ops/logmel_kernel.py:kernel_operands`` lays
out.  The kernel itself runs only on the card (tests/test_torch_cuda.py);
here the same operands, read back from the kernel's fragment order, go
through a torch emulation of its arithmetic:

* the DFT as fp32 frames @ packed W in fp64 (exact products, fp64 sums);
* the packed power rule, in fp64 and rounded once to fp32: re0^2 for bin
  0, slot^2 for bin n_fft/2 (the slot of sine 0), re^2 + im^2 for the
  others;
* TF32 rounding as ``cvt.rna.tf32.f32``: (bits + 0x1000) & 0xFFFFE000;
* the mel product as p_lo @ M_hi + p_hi @ M_lo + p_hi @ M_hi in fp32, the
  Nyquist bin in fp32.

The emulation is held against the JAX package's Pallas kernel (interpret
mode) and its XLA frontend at 8, 16 and 32 kHz, within the log-mel
tolerance rtol 1e-4, atol 1e-3 dB.  This shows, before the card, that
the split meets the tolerance.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.config import AUDIO_8K, AUDIO_16K, AUDIO_32K
from sed_tpu.dsp import filters as jax_filters
from sed_tpu.dsp import frontend as jax_fe
from sed_tpu.ops.logmel_kernel import fused_logmel as jax_fused_logmel
from sed_tpu_torch.dsp import frontend as fe
from sed_tpu_torch.ops import logmel_kernel as lk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-3)
CFGS = pytest.mark.parametrize('cfg', [AUDIO_8K, AUDIO_16K, AUDIO_32K],
                               ids=['8k', '16k', '32k'])
SPAN_PAD = 4        # logmel.cu kSpanPad
CPU = torch.device('cpu')


def read_dft(tiles: torch.Tensor, n: int) -> torch.Tensor:
    """Fragment order -> (n, n) float64 in packed column order (the inverse
    of ``lk.dft_tiles``)."""
    w = tiles.reshape(n // 128, n // 8, 16, 8, 4, 2)
    return w.permute(1, 5, 4, 0, 2, 3).reshape(n, n)


def read_mel(tiles: torch.Tensor, h: int):
    """Fragment order -> (M_hi, M_lo), each (n_fft/2, 64) (the inverse of
    ``lk.mel_tiles``)."""
    w = tiles.reshape(h // 8, 8, 8, 4, 2, 2)
    return tuple(w.permute(4, 0, 3, 5, 1, 2).reshape(2, h, 64))


def emulate_kernel(wav: np.ndarray, cfg) -> np.ndarray:
    """(B, samples) -> (B, T, 64) log-mel, in the kernel's arithmetic on
    the kernel's operands."""
    ops = lk.kernel_operands(cfg, CPU)
    n = cfg.window_size
    h = n // 2
    m_hi, m_lo = read_mel(ops.mel, h)
    frames = fe.frame_signal(torch.from_numpy(wav), n, cfg.hop_size,
                             cfg.center, cfg.pad_mode)
    y = frames.double() @ read_dft(ops.dft, n)
    y = y.reshape(*y.shape[:2], h // 8, 2, 8)
    re = y[..., 0, :].reshape(*y.shape[:2], h)
    im = y[..., 1, :].reshape(*y.shape[:2], h)
    power = re * re + im * im
    power[..., 0] = re[..., 0] * re[..., 0]
    nyq = (im[..., 0] * im[..., 0]).float()
    p_hi, p_lo = lk.split_tf32(power.float())
    mel = (p_lo @ m_hi + p_hi @ m_lo + p_hi @ m_hi
           + nyq[..., None] * ops.mel_nyq)
    return fe.power_to_db(mel, ref=cfg.ref, amin=cfg.amin).numpy()


def kernel_rows(cfg, seed: int) -> np.ndarray:
    """4 clips of 1.37 s (138 frames: no 64-frame tile divides it): a
    -0.5..0.5 uniform clip, a 1e-4-level clip, a half digitally silent clip
    and a full-scale +-1.0 clip."""
    rng = np.random.RandomState(seed)
    n = int(cfg.sample_rate * 1.37)
    loud = rng.uniform(-0.5, 0.5, n)
    quiet = rng.uniform(-0.5, 0.5, n)
    quiet *= 1e-4 / np.sqrt(np.mean(quiet ** 2))
    half = rng.uniform(-0.5, 0.5, n)
    half[:n // 2] = 0.0
    full = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    return np.stack([loud, quiet, half, full]).astype(np.float32)


def test_tf32_round_is_cvt_rna():
    """Nearest TF32 value, ties away from zero, on both signs."""
    x = torch.tensor([1.0, -1.0, 0.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -12), -(1.0 + 2.0 ** -11)])
    want = torch.tensor([1.0, -1.0, 0.0, 1.0 + 2.0 ** -10, 1.0,
                         -(1.0 + 2.0 ** -10), -(1.0 + 2.0 ** -10)])
    torch.testing.assert_close(lk.tf32_round(x), want, rtol=0, atol=0)
    bits = lk.tf32_round(torch.randn(1000)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0


@CFGS
def test_packed_dft_reads_back_frontend_columns(cfg):
    stft, _ = (torch.from_numpy(np.ascontiguousarray(m))
               for m in jax_filters.frontend_arrays(cfg))
    n = cfg.window_size
    h = n // 2
    cos, sin = stft[:, :h + 1], stft[:, h + 1:]
    packed = lk.pack_dft(stft)
    assert packed.shape == (n, n)
    by_group = packed.reshape(n, h // 8, 2, 8)
    got_cos = by_group[:, :, 0].reshape(n, h)
    got_sin = by_group[:, :, 1].reshape(n, h)
    torch.testing.assert_close(got_cos, cos[:, :h], rtol=0, atol=0)
    torch.testing.assert_close(got_sin[:, 1:], sin[:, 1:h], rtol=0, atol=0)
    torch.testing.assert_close(got_sin[:, 0], cos[:, h], rtol=0, atol=0)
    dropped = max(sin[:, 0].abs().max().item(), sin[:, h].abs().max().item())
    print(f'{cfg.name}: dropped sine columns max |.| = {dropped!r}')
    assert dropped < 1e-12

    dft = lk.kernel_operands(cfg, CPU).dft
    assert dft.dtype == torch.float64 and dft.numel() == n * n
    torch.testing.assert_close(read_dft(dft, n), packed.double(), rtol=0,
                               atol=0)


@CFGS
def test_mel_tiles_read_back_and_mask_covers_every_weight(cfg):
    _, mel = (torch.from_numpy(np.ascontiguousarray(m))
              for m in jax_filters.frontend_arrays(cfg))
    h = cfg.window_size // 2
    ops = lk.kernel_operands(cfg, CPU)
    m_hi, m_lo = read_mel(ops.mel, h)
    hi, lo = lk.split_tf32(mel[:h])
    torch.testing.assert_close(m_hi, hi, rtol=0, atol=0)
    torch.testing.assert_close(m_lo, lo, rtol=0, atol=0)
    for part in (m_hi, m_lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((m_hi.double() + m_lo.double() - mel[:h].double()).abs()
           / mel[:h].double().abs().clamp_min(1e-30)).max().item()
    print(f'{cfg.name}: max |M_hi + M_lo - M| / |M| = {rel!r}')
    assert rel <= 2.0 ** -22
    torch.testing.assert_close(ops.mel_nyq, mel[h], rtol=0, atol=0)
    bits = ops.mel_mask.to(torch.int64)
    assert ops.mel_mask.dtype == torch.uint8 and bits.shape == (h // 8,)
    kept = ((bits[:, None] >> torch.arange(8)) & 1).bool()      # (group, m)
    skipped = mel[:h].reshape(h // 8, 8, 8, 8).permute(0, 2, 1, 3)[~kept]
    assert skipped.abs().max().item() == 0.0
    print(f'{cfg.name}: mel tiles kept {int(kept.sum())} of {kept.numel()}')
    assert kept.sum() < kept.numel() // 2


def _a_fragment_wavefronts(hop: int, n_fft: int, pad: int) -> int:
    """Worst shared-memory wavefront count of the kernel's A-fragment
    loads (32-bit, one per lane) over the 4 row groups of warps, k-steps
    and the four loads of a fragment; 1 means no bank conflict.  Addresses
    as logmel.cu computes them: row * (hop + pad) + k + t + pad * (k / hop).
    """
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    worst = 0
    for rg in range(4):
        for dr in (0, 8):
            for dk in (0, 4):
                row = 16 * rg + dr + g
                k = np.arange(0, n_fft, 8)[:, None]
                addr = row * (hop + pad) + k + t + dk + pad * (k // hop)
                sample = row * hop + k + t + dk       # what the span holds
                np.testing.assert_array_equal(
                    addr, sample + pad * (sample // hop))
                for a in addr:
                    per_bank = {}
                    for x in np.unique(a):
                        per_bank[x % 32] = per_bank.get(x % 32, 0) + 1
                    worst = max(worst, max(per_bank.values()))
    return worst


@CFGS
def test_skewed_span_has_no_bank_conflicts(cfg):
    skewed = _a_fragment_wavefronts(cfg.hop_size, cfg.window_size, SPAN_PAD)
    plain = _a_fragment_wavefronts(cfg.hop_size, cfg.window_size, 0)
    print(f'{cfg.name} (hop {cfg.hop_size}): A-fragment wavefronts per load '
          f'{skewed} with the skew, {plain} without')
    assert skewed == 1
    assert plain > 1


@CFGS
def test_emulated_kernel_matches_jax(cfg):
    wav = kernel_rows(cfg, seed=cfg.sample_rate)
    got = emulate_kernel(wav, cfg)
    pallas = np.asarray(jax_fused_logmel(jnp.asarray(wav), cfg,
                                         interpret=True))
    xla = np.asarray(jax_fe.LogmelFrontend(cfg)(jnp.asarray(wav)))
    assert got.shape == pallas.shape == xla.shape == (4, 138, 64)
    assert got.shape[1] % 64 != 0
    assert np.isfinite(got).all()
    for name, want in (('pallas', pallas), ('xla', xla)):
        err = np.abs(got - want).max(axis=(1, 2))
        print(f'{cfg.name}: max |emulated - {name}| dB per clip '
              f'(loud, 1e-4, half silent, full scale) = {err.tolist()}')
        np.testing.assert_allclose(got, want, **TOL)
    assert got[2, :20].max() <= -100.0 + 1e-3        # the amin clamp


@CFGS
def test_emulated_nyquist_bin_reaches_the_mel_product(cfg):
    """With fmax past sr/2 the top mel filter weighs bin n_fft/2, which
    the kernel carries in the slot of sine 0."""
    wide = dataclasses.replace(cfg, fmax=int(cfg.sample_rate * 0.6))
    assert np.abs(jax_filters.frontend_arrays(wide)[1][-1]).max() > 0
    wav = kernel_rows(cfg, seed=cfg.sample_rate + 1)
    wav[0] += 0.4 * (-1.0) ** np.arange(wav.shape[1])   # a Nyquist tone
    got = emulate_kernel(wav, wide)
    want = np.asarray(jax_fe.LogmelFrontend(wide)(jnp.asarray(wav)))
    print(f'{cfg.name} fmax {wide.fmax}: max |emulated - xla| = '
          f'{np.abs(got - want).max()!r} dB')
    np.testing.assert_allclose(got, want, **TOL)


def test_fp64_dft_holds_where_3xtf32_does_not():
    """A 32 kHz bench-corpus clip with frames whose faint mel bands lie
    ~80 dB below their loud bins: the DFT's sums cancel, and an error
    relative to sum |x w| shows.  3xTF32 products (2^-21) put such bands
    ~0.007 dB off a float64 evaluation, near the log-mel tolerance; the
    kernel's fp64 DFT keeps them within 1e-4 dB."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from bench_corpus import make_clips
    cfg = AUDIO_32K
    n = cfg.window_size
    h = n // 2
    wav = make_clips(4, cfg.sample_rate, seconds=5, seed=12)[3:]
    stft, mel = (torch.from_numpy(np.ascontiguousarray(m)).double()
                 for m in jax_filters.frontend_arrays(cfg))
    spec = fe.spectrogram(torch.from_numpy(wav).double(), stft, cfg.hop_size,
                          cfg.center, cfg.pad_mode)
    ref = fe.power_to_db(spec @ mel, ref=cfg.ref, amin=cfg.amin).numpy()
    got = emulate_kernel(wav, cfg)

    w_hi, w_lo = lk.split_tf32(lk.pack_dft(stft.float()))
    frames = fe.frame_signal(torch.from_numpy(wav), n, cfg.hop_size,
                             cfg.center, cfg.pad_mode)
    x_hi, x_lo = (x.double() for x in lk.split_tf32(frames))
    y = x_lo @ w_hi.double() + x_hi @ w_lo.double() + x_hi @ w_hi.double()
    y = y.reshape(*y.shape[:2], h // 8, 2, 8)
    power = (y * y).sum(3).reshape(*y.shape[:2], h)
    power[..., 0] = y[..., 0, 0, 0] ** 2
    tf32 = fe.power_to_db(power @ mel[:h], ref=cfg.ref,
                          amin=cfg.amin).numpy()
    err = np.abs(got - ref).max()
    err_3xtf32 = np.abs(tf32 - ref).max()
    print(f'32k corpus clip: max |. - float64| dB: fp64 DFT (the kernel) '
          f'{err!r}, 3xTF32 DFT {err_3xtf32!r}')
    assert err < 1e-4
    assert err_3xtf32 > 10 * err
