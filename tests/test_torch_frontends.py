"""The port's remaining DSP frontends against ``sed_tpu``: the
pseudo-CQT frontend (``dsp/cqt.py``), the transforms of
``dsp/transforms.py`` on tensors, and the gammatonegram plot CLI.

Inputs are made with numpy from a seed and run on the CPU (the card's
cases are in ``tests/test_torch_cuda.py``).  Tolerances are those of
``tests/test_transforms.py`` (DFTs 1e-3 against numpy's FFT, round trips
1e-4, ISTFT 2e-3), applied to the port against the gold and against
``sed_tpu``'s output on the same input; the CQT against float64 (see
its test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu import config as jax_config
from sed_tpu.dsp import cqt as jax_cqt
from sed_tpu.dsp import transforms as jax_tr
from sed_tpu.dsp.filters import stft_matrices as jax_stft_matrices
from sed_tpu.dsp.frontend import stft as jax_stft
from sed_tpu_torch import config
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.dsp import cqt
from sed_tpu_torch.dsp import transforms as tr
from sed_tpu_torch.dsp.filters import stft_matrices
from sed_tpu_torch.dsp.frontend import stft

CFGS = pytest.mark.parametrize('quality', ['8k', '16k', '32k'])


def _close(got, gold, want, atol):
    """The port within ``atol`` of the gold and of sed_tpu's output."""
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, gold, atol=atol)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)


@CFGS
def test_cqt_frontend_matches_sed_tpu(quality):
    """``CQTFrontend`` on the CPU: sed_tpu's log pseudo-CQT on bench
    clips, (B, samples // hop + 1, n_bins), its matrices as buffers.
    Both float32 sides lose precision in the faint low bins (power
    sums that cancel), so each is held to the same module run in
    float64: the port within 1e-2 dB of it (measured up to 3.5e-3 dB),
    and within 1e-2 dB plus sed_tpu's own error of sed_tpu (measured:
    sed_tpu 3.4e-2 dB from float64 at 16 kHz)."""
    cfg = config.QUALITY[quality]
    x = make_clips(3, cfg.sample_rate, seconds=2, seed=4)
    fe = cqt.CQTFrontend(cfg, n_bins=60, fmin=55.0, device='cpu')
    assert {k for k, _ in fe.named_buffers()} == {'stft_mat', 'cq_mat'}
    got = fe(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_cqt.CQTFrontend(
        jax_config.QUALITY[quality], n_bins=60, fmin=55.0)(jnp.asarray(x)))
    f64 = fe.double()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 2 * cfg.frames_per_second + 1, 60)
    assert np.abs(got - f64).max() <= 1e-2
    own = np.abs(want - f64).max()
    assert np.abs(got - want).max() <= 1e-2 + own


def test_cqt_frontend_tone_peak_and_device():
    """A 440 Hz tone peaks in the bin near 440 Hz (sed_tpu's test); the
    frontend asks for the card by default, which raises on a host
    without CUDA (no fallback to the CPU)."""
    cfg = config.AUDIO_16K
    t = np.arange(cfg.sample_rate) / cfg.sample_rate
    x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    out = cqt.CQTFrontend(cfg, n_bins=60, fmin=55.0, device='cpu')(
        torch.from_numpy(x)[None])[0].numpy()
    centers = cqt.cqt_frequencies(60, 55.0)
    assert 350 < centers[out.mean(axis=0).argmax()] < 550
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            cqt.CQTFrontend(cfg)


def test_dft_and_idft_match_sed_tpu():
    rng = np.random.RandomState(0)
    xr, xi = rng.randn(2, 64).astype(np.float32)
    zr, zi = tr.dft(torch.from_numpy(xr), torch.from_numpy(xi))
    jr, ji = jax_tr.dft(jnp.asarray(xr), jnp.asarray(xi))
    gold = np.fft.fft(xr + 1j * xi)
    _close(zr, gold.real, jr, 1e-3)
    _close(zi, gold.imag, ji, 1e-3)
    for norm in (None, 'ortho'):
        zr, zi = tr.dft(torch.from_numpy(xr), torch.from_numpy(xi), norm)
        br, bi = tr.idft(zr, zi, norm)
        jr, ji = jax_tr.idft(*jax_tr.dft(jnp.asarray(xr), jnp.asarray(xi),
                                         norm), norm)
        _close(br, xr, jr, 1e-4)
        _close(bi, xi, ji, 1e-4)


def test_rdft_and_irdft_match_sed_tpu():
    x = np.random.RandomState(2).randn(3, 64).astype(np.float32)
    for norm in (None, 'ortho'):
        zr, zi = tr.rdft(torch.from_numpy(x), norm)
        jr, ji = jax_tr.rdft(jnp.asarray(x), norm)
        gold = np.fft.rfft(x, norm=norm)
        assert zr.shape == (3, 33)
        _close(zr, gold.real, jr, 1e-3)
        _close(zi, gold.imag, ji, 1e-3)
        _close(tr.irdft(zr, zi, norm), x, jax_tr.irdft(jr, ji, norm), 1e-4)


def test_magphase_matches_sed_tpu():
    re, im = np.random.RandomState(3).randn(2, 5, 7).astype(np.float32)
    re[0, 0] = im[0, 0] = 0.0
    got = tr.magphase(torch.from_numpy(re), torch.from_numpy(im))
    want = jax_tr.magphase(jnp.asarray(re), jnp.asarray(im))
    gold = np.hypot(re, im)
    for g, w, gd in zip(got, want, (gold, re / np.maximum(gold, 1e-10),
                                    im / np.maximum(gold, 1e-10))):
        _close(g, gd, w, 1e-6)
    m, c, s = tr.magphase(torch.tensor([3.0]), torch.tensor([4.0]))
    assert (m.item(), c.item(), s.item()) == pytest.approx((5.0, 0.6, 0.8))


@pytest.mark.parametrize('center', [True, False])
@CFGS
def test_istft_matches_sed_tpu(quality, center):
    """``istft(stft(x))`` gives x back within 2e-3, and sed_tpu's istft
    of the same spectrum within 2e-3 (center: the whole clip at
    ``length``; without center, away from the frames' outer edges)."""
    cfg = config.QUALITY[quality]
    x = np.random.RandomState(3).uniform(
        -0.5, 0.5, (2, cfg.sample_rate)).astype(np.float32)
    n_fft, hop = cfg.window_size, cfg.hop_size
    re, im = stft(torch.from_numpy(x), torch.from_numpy(
        stft_matrices(n_fft)).float(), hop, center=center)
    jre, jim = jax_stft(jnp.asarray(x), jnp.asarray(jax_stft_matrices(n_fft)),
                        hop, center=center)
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-3)
    length = x.shape[1] if center else None
    back = tr.istft(re, im, n_fft, hop, length=length, center=center)
    want = np.asarray(jax_tr.istft(jre, jim, n_fft, hop, length=length,
                                   center=center))
    assert back.shape == want.shape
    # without center the first and last samples are divided by a window
    # sum near 0, which magnifies float32 noise on both sides
    inner = slice(None) if center else slice(n_fft, back.shape[1] - n_fft)
    _close(back[:, inner], x[:, :back.shape[1]][:, inner], want[:, inner],
           2e-3)


def test_istft_pads_to_length():
    cfg = config.AUDIO_8K
    x = np.random.RandomState(6).randn(1, 4000).astype(np.float32) * 0.1
    re, im = stft(torch.from_numpy(x), torch.from_numpy(
        stft_matrices(cfg.window_size)).float(), cfg.hop_size)
    back = tr.istft(re, im, cfg.window_size, cfg.hop_size, length=4400)
    assert back.shape == (1, 4400) and not back[0, 4000:].any()


def test_enframe_and_scalar_normalize_match_sed_tpu():
    x = np.arange(64, dtype=np.float32)[None]
    got = tr.enframe(torch.from_numpy(x), 16, 8).numpy()
    assert got.shape == (1, 16, 7)
    assert np.array_equal(got, np.asarray(jax_tr.enframe(jnp.asarray(x),
                                                         16, 8)))
    np.testing.assert_array_equal(got[0, :, 2], np.arange(16, 32))
    y = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    out = tr.scalar_normalize(torch.from_numpy(y), [1.0, 2.0], [2.0, 2.0])
    np.testing.assert_allclose(out.numpy(), [[0, 0], [1, 1]])
    assert np.array_equal(out.numpy(), np.asarray(jax_tr.scalar_normalize(
        jnp.asarray(y), [1.0, 2.0], [2.0, 2.0])))


def test_plot_cli_renders_gammatonegram_png(tmp_path):
    """The port's plot CLI renders a wav to a PNG headlessly (Agg),
    honouring --duration; --accurate takes the time-domain filterbank."""
    import matplotlib
    matplotlib.use('Agg')
    from sed_tpu_torch.data import audio_io
    from sed_tpu_torch.dsp import plot as plot_cli
    sr = 16000
    t = np.arange(sr * 2) / sr
    wav = tmp_path / 'tone.wav'
    audio_io.save_wav(str(wav), (0.5 * np.sin(2 * np.pi * 440 * t))
                      .astype(np.float32), sr)
    for flags, name in (([], 'gtg.png'), (['-a'], 'gtg_acc.png')):
        out = tmp_path / name
        plot_cli.main([str(wav), '-d', '1', *flags, '-o', str(out)])
        assert out.stat().st_size > 1000
        with open(out, 'rb') as f:
            assert f.read(8) == b'\x89PNG\r\n\x1a\n'
