"""sed_tpu_torch on the card: the CUDA log-mel kernel against its plain
PyTorch version, and the CUDA engine against the CPU engine (the GRU and
Transformer models, one window per clip and windowed merging).

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
import torch.nn.functional as F

from sed_tpu_torch import config
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


def test_cuda_transformer_matches_cpu(device):
    """Cnn_9layers_Transformer_FrameAtt at full width on
    ``transformer_variables``: 8 int16 bench-corpus clips through the
    CUDA engine give the CPU engine's events and XML, framewise within
    1e-4, and launch the kernel."""
    from sed_tpu_torch.compat.bench_weights import transformer_variables
    from sed_tpu_torch.compat.from_flax import load_variables
    from sed_tpu_torch.models.registry import get_model
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from bench_corpus import make_clips
    cfg = config.AUDIO_16K
    variables = transformer_variables(seed=0)
    engines = []
    for dev in ('cpu', device):
        model = get_model('Cnn_9layers_Transformer_FrameAtt', cfg)
        engines.append(engine.SedInferenceEngine(
            load_variables(model, variables), cfg, dev, batch_size=8))
    cpu, gpu = engines
    pcm = (np.clip(make_clips(8, cfg.sample_rate, seconds=5, seed=0), -1, 1)
           * 32767).astype(np.int16)
    before = fused_logmel.launches
    got = gpu.predict_clips(pcm)
    assert fused_logmel.launches > before
    assert sum(map(len, got[0])) > 0
    assert got == cpu.predict_clips(pcm)
    fw_gpu, cw_gpu = gpu.infer_framewise(pcm)
    fw_cpu, cw_cpu = cpu.infer_framewise(pcm)
    assert fw_gpu.shape == (8, 496, 25)
    np.testing.assert_allclose(fw_gpu, fw_cpu, atol=1e-4)
    np.testing.assert_allclose(cw_gpu, cw_cpu, atol=1e-4)


@pytest.mark.parametrize('step,window', [(0.5, 6), (1, 5)])
def test_cuda_windowed_matches_cpu(device, step, window):
    """``predict_clips_windowed`` on 4 bench-corpus clips of 10 s (int16):
    the CUDA engine gives the CPU engine's events and launches the
    kernel."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from bench_corpus import make_clips
    cfg = config.AUDIO_16K
    pcm = (np.clip(make_clips(4, cfg.sample_rate, seconds=10, seed=4), -1, 1)
           * 32767).astype(np.int16)
    names = [f'c{i}.wav' for i in range(4)]
    kw = dict(sample_duration=window, overlap=True, overlap_value=step,
              batch_size=18)
    cpu = engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, 'cpu'), cfg,
                                    'cpu', **kw)
    gpu = engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, device), cfg,
                                    device, **kw)
    before = fused_logmel.launches
    got = gpu.predict_clips_windowed(pcm, names, duration=10.0, step=step)
    assert fused_logmel.launches > before
    assert sum(map(len, got)) > 0
    assert got == cpu.predict_clips_windowed(pcm, names, duration=10.0,
                                             step=step)


def test_cuda_evaluator_refuses_tf32_and_matches_cpu(device):
    """The Evaluator on the card refuses TF32; with it off, its forward
    over 10 s clips (a ragged last batch) gives the CPU's outputs."""
    from sed_tpu_torch.eval.evaluator import Evaluator
    cfg = config.AUDIO_16K
    model = load_npz(CKPT, MODEL, cfg, 'cpu')
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match='TF32'):
            Evaluator(model, device)
    finally:
        engine.disable_tf32()
    wav = np.random.RandomState(3).uniform(-0.3, 0.3, (3, 160000)) \
        .astype(np.float32)
    loader = [{'audio_name': np.array(['a', 'b']), 'waveform': wav[:2]},
              {'audio_name': np.array(['c']), 'waveform': wav[2:]}]
    want = Evaluator(model, 'cpu').forward(loader)
    before = fused_logmel.launches
    got = Evaluator(load_npz(CKPT, MODEL, cfg, 'cpu'), device).forward(loader)
    assert fused_logmel.launches == before + 2
    assert got['framewise_output'].shape == (3, 1000, 25)
    np.testing.assert_allclose(got['framewise_output'],
                               want['framewise_output'], atol=1e-4)


@pytest.mark.parametrize('batch', [192, 64])
def test_kernel_at_the_training_shapes(device, batch):
    """The weak (192) and strong (64) batches of ``main_strong train
    --batch_size 32`` with mixup: clips of 10 s at 16 kHz, 1001 frames."""
    cfg = config.AUDIO_16K
    x = torch.from_numpy(_rows(cfg, batch, 10.0, seed=batch)).to(device)
    before = fused_logmel.launches
    got = fused_logmel(x, cfg)
    assert fused_logmel.launches == before + 1
    assert got.shape == (batch, 1001, 64)
    torch.testing.assert_close(got, logmel_plain(x, cfg), **TOL)


def test_kernel_refuses_a_waveform_that_requires_grad(device):
    """The kernel has no backward: a CUDA input that requires grad raises
    instead of coming back cut from its graph."""
    x = torch.zeros(2, 16000, device=device, requires_grad=True)
    with pytest.raises(ValueError, match='no backward'):
        fused_logmel(x, config.AUDIO_16K)
    assert fused_logmel(x.detach(), config.AUDIO_16K).shape == (2, 101, 64)


def test_train_step_gpu_matches_cpu(device):
    """Three joint steps (mixup on, augmentation off) of a narrow CnnSed
    from the same fresh weights on the card and on the CPU: losses within
    rtol 1e-4; parameters as ``tests/test_torch_train.py``'s three-step
    test holds them (AMSGrad turns float noise of near-zero gradients
    into moves of up to ~lr a step): max < 3 x 2 lr, mean < 1e-5, under
    5% of the elements beyond 1e-5; BatchNorm buffers within 5e-4
    (relative above 1); the log-mel kernel launched twice a step."""
    from sed_tpu_torch import losses
    from sed_tpu_torch.models.zoo import CnnSed
    from sed_tpu_torch.train.state import create_train_state
    from sed_tpu_torch.train.step import make_train_step
    cfg = config.AUDIO_16K
    rng = np.random.RandomState(0)
    lam = lambda n: np.repeat(rng.rand(n // 2), 2).astype(np.float32)  # noqa
    batches = []
    for _ in range(3):
        wav = (rng.uniform(-0.3, 0.3, (6, 16000)) * 32767).astype(np.int16)
        weak = {'waveform': wav[:4],
                'target': (rng.rand(4, 25) > 0.7).astype(np.float32),
                'mixup_lambda': lam(4)}
        strong = {'waveform': wav[4:],
                  'strong_target': (rng.rand(2, 100, 25) > 0.8)
                  .astype(np.float32), 'mixup_lambda': lam(2)}
        batches.append((weak, strong))
    states, steps = {}, {}
    for dev in ('cpu', device):
        model = CnnSed(cfg, conv_channels=(8, 16, 16, 32), temporal='gru',
                       gru_hidden=16, pad_to_roundup=True)
        states[dev] = create_train_state(model, 1e-3,
                                         torch.Generator().manual_seed(0))
        model.to(dev)
        steps[dev] = make_train_step(model, states[dev].optimizer,
                                     losses.clip_bce, losses.frame_bce,
                                     mixup=True, timeshift=False,
                                     spec_augment=False)
    before = fused_logmel.launches
    for weak, strong in batches:
        got = {}
        for dev in states:
            tw = {k: torch.from_numpy(v).to(dev) for k, v in weak.items()}
            ts = {k: torch.from_numpy(v).to(dev) for k, v in strong.items()}
            got[dev] = steps[dev](tw, [ts], None)['loss'].item()
        assert abs(got[device] - got['cpu']) <= 1e-4 * got['cpu']
    assert fused_logmel.launches == before + 6
    diffs = []
    cpu_state = states['cpu'].model.state_dict()
    for k, v in states[device].model.state_dict().items():
        w = cpu_state[k].double()
        d = (v.double().cpu() - w).abs()
        if 'running' in k:
            assert (d / w.abs().clamp_min(1.0)).max() < 5e-4, k
        elif not k.endswith('num_batches_tracked'):
            diffs.append(d.reshape(-1))
    d = torch.cat(diffs)
    print(f'GPU - CPU after 3 steps: max {d.max().item()!r} mean '
          f'{d.mean().item()!r} share > 1e-5 '
          f'{(d > 1e-5).double().mean().item()!r}')
    assert d.max() < 3 * 2e-3 and d.mean() < 1e-5
    assert (d > 1e-5).double().mean() < 0.05


def test_kernel_keeps_non_finite_frames_non_finite(device):
    """An inf or NaN sample makes the frames that hold it non-finite, as
    in the plain version and the Pallas kernel (``jnp.maximum`` keeps a
    NaN), not the -100 dB floor: a bad batch must look bad to the
    loss-scaled step.  Other frames are unchanged."""
    cfg = config.AUDIO_16K
    wav = _rows(cfg, 3, 1.0, seed=9)
    clean = torch.from_numpy(wav.copy()).to(device)
    wav[0, 8000] = np.inf
    wav[1, 3000] = np.nan
    x = torch.from_numpy(wav).to(device)
    got, want = fused_logmel(x, cfg), logmel_plain(x, cfg)
    bad = ~torch.isfinite(want).all(-1)
    assert bad[0].any() and bad[1].any() and not bad[2].any()
    assert torch.equal(~torch.isfinite(got).all(-1), bad)
    torch.testing.assert_close(got[~bad], fused_logmel(clean, cfg)[~bad],
                               rtol=0, atol=0)


FAMILIES = ['Cnn_9layers_Conformer_FrameAtt', 'Cnn_9layers_Conformer_FrameAvg',
            'Cnn_14layers_Conformer_FrameAtt', 'Cnn_7layers_Conformer',
            'Cnn_9layers_Conformer', 'VGGish_FrameAtt', 'VGGish_Gru_FrameAtt',
            'VGGish_FrameAvg', 'Cnn14_DecisionLevelAtt']


@pytest.mark.parametrize('name', FAMILIES)
def test_cuda_family_forward_matches_cpu(device, name):
    """Each of the Conformer, VGGish and CNN14 names at full width on
    seeded weights, 4 bench-corpus clips of 2 s: every output on the card
    within 1e-4 of the CPU's (logits: of max(1, |x|)), one kernel launch
    (VGGish skips ``bn0``, not the kernel)."""
    import copy
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.compat.bench_weights import seeded_model
    cfg = config.AUDIO_16K
    model = seeded_model(name, cfg, seed=1)
    wav = torch.from_numpy(make_clips(4, cfg.sample_rate, seconds=2, seed=8))
    with torch.inference_mode():
        want = model(wav)
        fused_logmel.launches = 0
        got = copy.deepcopy(model).to(device)(wav.to(device))
    assert fused_logmel.launches == 1
    for key, w in want.items():
        g = got[key].cpu()
        assert g.shape == w.shape and torch.isfinite(g).all(), key
        err = ((g - w).abs() / w.abs().clamp_min(1.0)).max().item()
        assert err <= 1e-4, (key, err)


@pytest.mark.parametrize('name', ['Cnn_9layers_Conformer_FrameAtt',
                                  'Cnn_7layers_Conformer',
                                  'Cnn14_DecisionLevelAtt'])
def test_cuda_family_dropouts_draw_from_the_generator(device, name):
    """A training-mode forward on the card draws SpecAugment and every
    dropout from the CUDA generator it is given: the same seed gives the
    same output, another seed another."""
    from sed_tpu_torch.compat.bench_weights import seeded_model
    cfg = config.AUDIO_16K
    model = seeded_model(name, cfg, seed=2).to(device).train()
    wav = torch.from_numpy(_rows(cfg, 4, 2.0, seed=3)).to(device)

    def run(seed):
        g = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            return model(wav, generator=g)['framewise_output']

    a, b, c = run(1), run(1), run(2)
    assert torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


@CFGS
def test_cuda_fft_gtgram_batch_matches_cpu_and_float64(device, cfg):
    """``fft_gtgram_batch`` on the card: the CPU's result and the numpy
    float64 ``fft_gtgram`` within 2e-5 of each clip's largest value (fp32
    sums of n_fft products; ``chip_smoke.py`` measured up to 6.1e-6 at
    32 kHz), trailing zero column kept."""
    from sed_tpu_torch.dsp import gammatone as gt
    args = (cfg.sample_rate, cfg.window_size / cfg.sample_rate,
            cfg.hop_size / cfg.sample_rate, cfg.mel_bins, cfg.fmin)
    nfft, _, nhop = gt._fft_gtgram_geometry(*args[:3])
    x = _rows(cfg, 4, 3.0, seed=5)[:, :nfft + 200 * nhop]
    got = gt.fft_gtgram_batch(torch.from_numpy(x).to(device), *args).cpu()
    cpu = gt.fft_gtgram_batch(torch.from_numpy(x), *args)
    assert got.shape == (4, cfg.mel_bins, 201)
    for i in range(4):
        gold = gt.fft_gtgram(x[i].astype(np.float64), *args)
        top = np.abs(gold).max()
        assert np.abs(got[i].numpy() - gold).max() <= 2e-5 * top
        assert (got[i] - cpu[i]).abs().max().item() <= 2e-5 * top
        assert not got[i, :, -1].any()


def test_cuda_gamma_model_matches_cpu(device):
    """A gamma model on the card: packed features through the GRU model,
    the CPU's outputs within 1e-4, and no log-mel launch."""
    from sed_tpu_torch.dsp import gammatone as gt
    from sed_tpu_torch.models.blocks import init_weights
    from sed_tpu_torch.models.registry import get_model
    cfg = config.AUDIO_16K
    clips = _rows(cfg, 3, 10.0, seed=8)
    feats = np.stack([gt.fft_gtgram_db(c, cfg).astype(np.int16)
                      for c in clips])
    x = torch.from_numpy(feats).float() / 32767.0
    model = init_weights(get_model(MODEL, cfg, feature_type='gamma'),
                         torch.Generator().manual_seed(4))
    # a trained bn0's statistics: the features' per-bin moments
    model.bn0.running_mean.copy_(x.mean(dim=(0, 2)))
    model.bn0.running_var.copy_(x.var(dim=(0, 2)))
    with torch.inference_mode():
        want = model(x)
        fused_logmel.launches = 0
        got = model.to(device)(x.to(device))
    assert fused_logmel.launches == 0
    assert got['framewise_output'].shape == (3, 1000, 25)
    for key in ('framewise_output', 'clipwise_output'):
        assert (got[key].cpu() - want[key]).abs().max().item() <= 1e-4, key


def test_cuda_cqt_frontend_matches_cpu(device):
    """``CQTFrontend`` on the card against float64: within 1e-2 dB plus
    the CPU float32 module's own error (``tests/test_torch_frontends.py``'s
    bound)."""
    from sed_tpu_torch.dsp.cqt import CQTFrontend
    cfg = config.AUDIO_16K
    x = torch.from_numpy(_rows(cfg, 4, 2.0, seed=9))
    fe_gpu = CQTFrontend(cfg)
    assert fe_gpu.cq_mat.device.type == 'cuda'
    got = fe_gpu(x.to(device)).cpu()
    cpu = CQTFrontend(cfg, device='cpu')(x)
    f64 = CQTFrontend(cfg, device='cpu').double()(x.double())
    assert got.shape == (4, 201, 80)
    own = (cpu.double() - f64).abs().max().item()
    assert (got.double() - f64).abs().max().item() <= 1e-2 + own


def test_cuda_istft_round_trip(device):
    """``istft(stft(x))`` on the card gives x back within 2e-3
    (``tests/test_transforms.py``'s bound)."""
    from sed_tpu_torch.dsp import filters
    from sed_tpu_torch.dsp import transforms as tr
    cfg = config.AUDIO_16K
    x = torch.from_numpy(_rows(cfg, 3, 2.0, seed=11)).to(device)
    mat = torch.from_numpy(filters.stft_matrices(cfg.window_size)).float()
    re, im = fe.stft(x, mat.to(device), cfg.hop_size)
    back = tr.istft(re, im, cfg.window_size, cfg.hop_size,
                    length=x.shape[1])
    assert back.device.type == 'cuda' and back.shape == x.shape
    assert (back - x).abs().max().item() <= 2e-3


def _pcm(n: int, seed: int) -> np.ndarray:
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from bench_corpus import make_clips
    clips = make_clips(n, config.AUDIO_16K.sample_rate, seconds=5, seed=seed)
    return (np.clip(clips, -1, 1) * 32767).astype(np.int16)


def test_cuda_bf16_serving_within_the_gate(device):
    """The bench checkpoint with a bf16 conv stack on the card against the
    float32 engine on the card, 16 int16 clips: framewise within 0.05,
    events (label, onset and offset within 0.05 s) matched both ways for
    at least 90% (``sed_tpu``'s gate, ``tests/test_serve.py:796``); the
    log-mel kernel launched, on a float32 input."""
    sys.path.insert(0, REPO)
    from chip_smoke import event_match
    cfg = config.AUDIO_16K
    pcm = _pcm(16, seed=5)
    eng = {tag: engine.SedInferenceEngine(
        load_npz(CKPT, MODEL, cfg, device, compute_dtype=dtype), cfg,
        device, batch_size=16)
        for tag, dtype in (('f32', None), ('bf16', torch.bfloat16))}
    before = fused_logmel.launches
    fb, _ = eng['bf16'].infer_framewise(pcm)
    assert fused_logmel.launches == before + 1
    fa, _ = eng['f32'].infer_framewise(pcm)
    assert np.abs(fa - fb).max() < 0.05
    ea, _ = eng['f32'].predict_clips(pcm)
    eb, _ = eng['bf16'].predict_clips(pcm)
    assert sum(map(len, ea)) > 0
    assert event_match(ea, eb) >= 0.9


def test_cuda_bf16_train_steps_finite_and_near_float32(device):
    """Three dynamically loss-scaled bf16 steps of a narrow CnnSed on the
    card (mixup, SpecAugment and timeshift on) against float32 from the
    same init, batches and generator seed: no skipped step, each loss
    within 2e-2 of float32's (``chip_smoke.py:BF16_LOSS_RTOL``), the
    parameters float32 and finite."""
    from sed_tpu_torch import losses
    from sed_tpu_torch.models.zoo import CnnSed
    from sed_tpu_torch.train.state import create_train_state
    from sed_tpu_torch.train.step import init_loss_scale, make_train_step
    rng = np.random.RandomState(3)
    wav = torch.from_numpy((rng.uniform(-0.3, 0.3, (6, 16000)) * 32767)
                           .astype(np.int16)).to(device)
    lam = torch.from_numpy(np.repeat(rng.rand(3), 2).astype(np.float32))
    weak = {'waveform': wav[:4], 'mixup_lambda': lam[:4].to(device),
            'target': torch.from_numpy((rng.rand(4, 25) > 0.7)
                                       .astype(np.float32)).to(device)}
    strong = {'waveform': wav[4:], 'mixup_lambda': lam[4:].to(device),
              'strong_target': torch.from_numpy(
                  (rng.rand(2, 100, 25) > 0.8).astype(np.float32)).to(device)}
    got = {}
    for tag, dtype in (('f32', None), ('bf16', torch.bfloat16)):
        model = CnnSed(config.AUDIO_16K, conv_channels=(8, 16, 16, 32),
                       temporal='gru', gru_hidden=16, pad_to_roundup=True,
                       compute_dtype=dtype)
        state = create_train_state(model, 1e-3,
                                   torch.Generator().manual_seed(0))
        model.to(device)
        step = make_train_step(model, state.optimizer, losses.clip_bce,
                               losses.frame_bce, mixup=True, timeshift=True,
                               spec_augment=True,
                               loss_scale='dynamic' if dtype else None)
        gen, ss, out = torch.Generator(device=device).manual_seed(7), \
            init_loss_scale(), []
        for _ in range(3):
            if dtype is None:
                out.append(step(weak, [strong], gen)['loss'].item())
            else:
                m, ss = step(weak, [strong], gen, ss)
                assert m['grads_finite']
                out.append(m['loss'].item())
        got[tag] = np.array(out)
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in model.parameters())
    assert (np.abs(got['bf16'] - got['f32']) <= 2e-2 * got['f32']).all(), got


def test_cuda_replicated_engine_matches_one_device(device):
    """``devices=['cuda', 'cuda']``: two replicas on the card, each batch
    split in two; int16 and adpcm4 events and XML identical to the
    single-device engine."""
    from sed_tpu_torch.data import audio_io
    cfg = config.AUDIO_16K
    model = load_npz(CKPT, MODEL, cfg, device)
    one = engine.SedInferenceEngine(model, cfg, device, batch_size=8)
    two = engine.SedInferenceEngine(model, cfg, devices=[device, device],
                                    batch_size=8)
    pcm = _pcm(12, seed=9)
    adpcm = audio_io.adpcm_encode_np(pcm.astype(np.float32) / 32767)
    for wire in (pcm, adpcm):
        before = fused_logmel.launches
        got = two.predict_clips(wire)
        assert fused_logmel.launches == before + 4     # 2 batches x 2
        assert got == one.predict_clips(wire)


def test_cuda_dp_step_in_a_one_rank_gloo_group(device, tmp_path):
    """The data-parallel step (gloo's all-reduce on CUDA tensors: the
    BatchNorm statistics in float64, the flat gradient buffer, the finite
    flag) in a 1-rank group against the plain step from the same init:
    losses within 1e-6, gradients within 1e-5 of each tensor's max |g|
    (a floor of 1e-6 of the largest: a zero gradient's float noise)."""
    import torch.distributed as dist
    from sed_tpu_torch import losses
    from sed_tpu_torch.models.zoo import CnnSed
    from sed_tpu_torch.train.state import create_train_state
    from sed_tpu_torch.train.step import LossScaleState, make_train_step
    rng = np.random.RandomState(4)
    wav = torch.from_numpy(rng.uniform(-0.3, 0.3, (6, 16000))
                           .astype(np.float32)).to(device)
    weak = {'waveform': wav[:4], 'target': torch.from_numpy(
        (rng.rand(4, 25) > 0.7).astype(np.float32)).to(device)}
    strong = {'waveform': wav[4:], 'strong_target': torch.from_numpy(
        (rng.rand(2, 100, 25) > 0.8).astype(np.float32)).to(device)}
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/store',
                            rank=0, world_size=1)
    try:
        got = {}
        for tag in ('plain', 'dp'):
            model = CnnSed(config.AUDIO_16K, conv_channels=(8, 16, 16, 32),
                           temporal='gru', gru_hidden=16, pad_to_roundup=True)
            state = create_train_state(model, 1e-3,
                                       torch.Generator().manual_seed(0))
            model.to(device)
            step = make_train_step(
                model, state.optimizer, losses.clip_bce, losses.frame_bce,
                mixup=False, timeshift=True, spec_augment=True,
                loss_scale='dynamic',
                group=dist.group.WORLD if tag == 'dp' else None)
            m, _ = step(weak, [strong], torch.Generator(
                device=device).manual_seed(2), LossScaleState(4096.0, 0))
            assert m['grads_finite']
            got[tag] = (m['loss'].item(),
                        {k: p.grad for k, p in model.named_parameters()})
    finally:
        dist.destroy_process_group()
    (lp, gp), (ld, gd) = got['plain'], got['dp']
    assert abs(lp - ld) <= 1e-6 * lp
    floor = 1e-6 * max(g.abs().max() for g in gp.values())
    for k, g in gp.items():
        assert (gd[k] - g).abs().max() <= 1e-5 * g.abs().max() + floor, k


def _v6_pool(clips):
    from sed_tpu_torch.data import audio_io
    rows = [audio_io.v6_encode_clip(x) for x in clips]
    pool = np.concatenate(rows + [np.zeros(8192, np.uint8)])
    offsets = np.concatenate([[0], np.cumsum([r.nbytes for r in rows])])
    return rows, pool.view(np.int32), (offsets // 4).astype(np.int32)


def test_cuda_v6_predictor_kernel_bit_exact(device):
    """``csrc/v6_decode.cu`` (the whole pool decode, one launch) against
    its plain version on the card and ``v6_decode_np``, bitwise, on
    bench-corpus clips, a 7.9 kHz tone and a padding row; then on a
    seeded random-word pool (width-7 modes, order-3 wrap, NaN scales,
    offsets into the tail, past the pool and negative); and its
    refusals."""
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.data import audio_io
    from sed_tpu_torch.ops import wire
    t = np.arange(80000) / 16000
    clips = np.concatenate([make_clips(5, 16000, seconds=5, seed=12),
                            (0.9 * np.sin(2 * np.pi * 7900 * t))[None]
                            ]).astype(np.float32)
    rows, pool, offsets = _v6_pool(clips)
    pool_d = torch.from_numpy(pool).to(device)
    offs_d = torch.from_numpy(offsets).to(device)
    before = wire.dequant_v6_pool.launches
    got = wire.dequant_v6_pool(pool_d, offs_d, 80000)
    assert wire.dequant_v6_pool.launches == before + 1
    want = wire._v6_decode_plain(pool_d, offs_d, 80000)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    dec = got.cpu().numpy()
    for i, row in enumerate(rows):
        assert np.array_equal(dec[i].view(np.int32), audio_io.v6_decode_np(
            row, 80000).view(np.int32))
    assert not dec[-1].view(np.int32).any()
    rng = np.random.RandomState(0)
    for samples in (80000, 16000, 4096 + 128):
        words = torch.from_numpy(rng.randint(
            -2 ** 31, 2 ** 31, 40000, dtype=np.int64).astype(np.int32))
        offs = torch.from_numpy(np.array(
            [0, 17, 39990, 39999, 50000, -5, 2 ** 31 - 9, 12345], np.int32))
        got = wire.dequant_v6_pool(words.to(device), offs.to(device), samples)
        want = wire._v6_decode_plain(words.to(device), offs.to(device),
                                     samples)
        assert torch.isnan(want).any()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match='offsets'):
        wire.dequant_v6_pool(pool_d, offs_d.long(), 80000)
    with pytest.raises(ValueError, match='offsets'):
        wire.dequant_v6_pool(pool_d, offs_d.cpu(), 80000)
    with pytest.raises(ValueError, match='blocks'):
        wire.dequant_v6_pool(pool_d, offs_d, 80000 + 64)


ADPCM_BITS = pytest.mark.parametrize('bits', [4, 3, 2])


@ADPCM_BITS
def test_cuda_adpcm_kernel_bit_exact(device, bits):
    """``csrc/adpcm_decode.cu`` against its plain version on the card,
    bitwise, at 1, 7, 32, 33 and 256 rows of 5 s and 10 s (a part run of
    ADPCM blocks at every row's end, a part last wave): encodings of
    bench-corpus clips and a full-scale square wave, and seeded random
    bytes (clamped step indices, saturating codes); inputs at an odd
    byte address (a contiguous view at storage offset 1, a row slice
    ``big[1:]``); one launch a decode; the wrapper's refusals."""
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.data import audio_io
    from sed_tpu_torch.ops import wire
    rng = np.random.RandomState(bits)
    for samples in (80000, 160000):
        sq = np.where((np.arange(samples) // 37) % 2 == 0, 1.0, -1.0)
        x = np.concatenate([make_clips(7, 16000, seconds=samples // 16000,
                                       seed=bits), sq[None]])
        enc = (audio_io.adpcm_encode_np(x) if bits == 4
               else audio_io.adpcm_n_encode_np(x, bits))
        width = enc.shape[1]
        big = torch.from_numpy(rng.randint(0, 256, (34, width)).astype(
            np.uint8)).to(device)
        flat = torch.cat([big.new_zeros(1), big.reshape(-1)])
        unaligned = (flat[1:].view(34, width), big[1:])
        assert all(w.is_contiguous() and w.data_ptr() % 2 for w in unaligned)
        for rows in (1, 7, 32, 33, 256):
            for wav in (torch.from_numpy(enc[np.arange(rows) % len(enc)]),
                        torch.from_numpy(rng.randint(
                            0, 256, (rows, width)).astype(np.uint8)),
                        *(w[:rows] for w in unaligned if rows <= 33)):
                wav = wav.to(device)
                before = wire._adpcm_decode.launches
                got = wire.dequant_wire(wav, samples)
                assert wire._adpcm_decode.launches == before + 1
                want = wire._adpcm_decode_plain(wav, samples, bits)
                torch.cuda.synchronize()
                assert got.shape == (rows, samples)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
    wide = torch.zeros((2, enc.shape[1] + 3), dtype=torch.uint8,
                       device=device)
    with pytest.raises(ValueError, match='contiguous'):
        wire._adpcm_decode(wide[:, :enc.shape[1]], 160000, bits)
    with pytest.raises(ValueError, match='contiguous'):
        wire._adpcm_decode(wide[:, :enc.shape[1]].short(), 160000, bits)
    with pytest.raises(ValueError, match='hold'):
        wire._adpcm_decode(wide[:, :enc.shape[1] - 256].contiguous(),
                           160000, bits)


def test_cuda_resident_passes_match_cpu(device):
    """``predict_clips_resident`` (q6) and ``predict_rows_resident`` (v6)
    on the card: events and XML identical to the CPU engine's, and the
    v6 pass equal to the q6 wire's."""
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.data import audio_io
    cfg = config.AUDIO_16K
    gpu = engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, device), cfg,
                                    device, batch_size=8)
    cpu = engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, 'cpu'), cfg,
                                    'cpu', batch_size=8)
    clips = make_clips(12, 16000, seconds=5, seed=13)
    q6 = audio_io.qn_encode(clips, 6)
    rows = [audio_io.v6_encode_clip(x) for x in clips]
    want = cpu.predict_clips(q6)
    assert gpu.predict_clips_resident(q6) == want
    assert gpu.predict_rows_resident(rows) == want
    assert cpu.predict_rows_resident(rows) == want


def _bench_forward(device, clips: int = 32, grad: bool = False) -> dict:
    """The bench checkpoint's GRU model in eval mode on ``clips`` 5 s
    bench-corpus clips: {output name: numpy array}.  ``grad``: with
    autograd on (the parameters want gradients), so that the float32 3x3
    convolutions run in cuDNN under the measured choice, not in
    ``csrc/conv3x3.cu``."""
    from sed_tpu_torch.bench_corpus import make_clips
    cfg = config.AUDIO_16K
    wav = torch.from_numpy(make_clips(clips, cfg.sample_rate, seconds=5,
                                      seed=0)).to(device)
    model = load_npz(CKPT, MODEL, cfg, device).eval()
    with torch.inference_mode(not grad):
        out = model(wav)
    return {k: out[k].detach().cpu().numpy()
            for k in ('framewise_output', 'clipwise_output')}


def test_cuda_measured_conv_choice_matches_the_heuristic(device, tmp_path):
    """32 x 5 s clips through the conv stack under cuDNN's measured
    choice (a forward with autograd on, which the 3x3 kernel does not
    take) are within 1e-5 of the same forward under its heuristic
    (benchmark off), run in a process of its own: the plan that a
    process picks first for a shape is the one it keeps."""
    path = tmp_path / 'heuristic.npz'
    code = ('import sys, numpy as np, torch; sys.path[:0] = [{r!r}, {t!r}]; '
            'from sed_tpu_torch.models import blocks; '
            'from sed_tpu_torch.serve import engine; engine.disable_tf32(); '
            'torch.backends.cudnn.benchmark = False; '
            'blocks._on_card = lambda x: False; '
            'import test_torch_cuda as t; '
            'np.savez({p!r}, **t._bench_forward("cuda", grad=True))').format(
                r=REPO, t=os.path.join(REPO, 'tests'), p=str(path))
    import subprocess
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO,
                   timeout=600)
    from sed_tpu_torch.models import blocks
    calls = blocks.Conv2d.measured_calls
    got = _bench_forward(device, grad=True)
    assert blocks.Conv2d.measured_calls == calls + 8
    want = np.load(path)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5, err_msg=k)


def test_cuda_conv_search_once_per_shape(device, monkeypatch):
    from sed_tpu_torch.models import blocks
    monkeypatch.setattr(blocks.Conv2d, '_searched', set())
    # bf16: a compute dtype the 3x3 kernel does not take
    block = blocks.ConvBlock(1, 16, dtype=torch.bfloat16).to(device).eval()
    before = torch.backends.cudnn.benchmark
    calls, searched = blocks.Conv2d.measured_calls, \
        blocks.Conv2d.searched_shapes
    for batch, want in ((4, (2, 2)), (4, (4, 2)), (2, (6, 4)), (4, (8, 4))):
        with torch.no_grad():
            block(torch.randn(batch, 1, 101, 64, device=device))
        assert (blocks.Conv2d.measured_calls - calls,
                blocks.Conv2d.searched_shapes - searched) == want, batch
    torch.cuda.synchronize()
    assert torch.backends.cudnn.benchmark == before


def test_cuda_no_fft_convolution_at_5s(device):
    """A profiled eval-mode forward of 32 x 5 s clips with autograd on
    (so that cuDNN, not the 3x3 kernel, runs the convolutions), after a
    warm one, runs its convolutions with no FFT kernel (cuDNN's heuristic
    picks one for one layer of the 5 s stack)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _bench_forward(device, grad=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _bench_forward(device, grad=True)
    events = list(prof.events())
    kernels = {e.name for e in events if e.device_type != DeviceType.CPU}
    convs = [e for e in events if e.name == 'aten::cudnn_convolution']
    assert len(convs) == 8
    fft = sorted(k for k in kernels if 'fft' in k.lower() or 'DSE::' in k
                 or 'complex' in k)
    assert not fft, fft


# ---------------------------------------------------------------------------
# csrc/conv_epilogue.cu: BatchNorm (eval), ReLU and the 2x2 average pool in
# one pass.  Relative error: max |kernel - plain| over max |plain| (the
# kernel's scale-and-shift form is an ulp or so from cuDNN's inference
# BatchNorm).
# ---------------------------------------------------------------------------

EPILOGUE_REL_TOL = 1e-6


def _epilogue_bn(channels: int, seed: int, device):
    from sed_tpu_torch.models import blocks
    rng = np.random.RandomState(seed)
    bn = blocks.BatchNorm(channels).eval()
    with torch.no_grad():
        for t, lo, hi in ((bn.running_mean, -1.0, 1.0),
                          (bn.running_var, 0.01, 4.0),
                          (bn.weight, 0.2, 2.0), (bn.bias, -1.0, 1.0)):
            t.copy_(torch.from_numpy(rng.uniform(lo, hi, channels)
                                     .astype(np.float32)))
    return bn.requires_grad_(False).to(device)


def _epilogue_args(bn):
    return (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)


def _stack_epilogues(frames: int):
    """(channels, height, width, pool) of the 8 epilogues of the 4-block
    stack on ``frames`` log-mel frames of 64 bins."""
    out, h, w = [], frames, 64
    for i, c in enumerate((64, 128, 256, 512)):
        pool = (1, 1) if i == 3 else (2, 2)
        out += [(c, h, w, (1, 1)), (c, h, w, pool)]
        h, w = h // pool[0], w // pool[1]
    return out


def _rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize('frames', [501, 601, 1001])
@pytest.mark.parametrize('batch', [1, 9, 27, 32])
def test_cuda_conv_epilogue_matches_plain_at_the_stack_shapes(device, batch,
                                                              frames):
    """Every epilogue of the stack at the cells' frame counts and batches;
    the pool equals avg_pool2d's bit for bit on the kernel's own
    BatchNorm-ReLU output."""
    from sed_tpu_torch.ops import conv_epilogue as ce
    gen = torch.Generator(device=device).manual_seed(batch * frames)
    for i, (c, h, w, pool) in enumerate(_stack_epilogues(frames)):
        bn = _epilogue_bn(c, seed=i, device=device)
        x = torch.randn(batch, c, h, w, device=device, generator=gen) * 2
        launches = ce.conv_epilogue.launches
        got = ce.conv_epilogue(x, *_epilogue_args(bn), pool)
        assert ce.conv_epilogue.launches == launches + 1
        want = ce.conv_epilogue_plain(x, *_epilogue_args(bn), pool)
        assert got.shape == want.shape
        err = _rel_err(got, want)
        assert err <= EPILOGUE_REL_TOL, (c, h, w, pool, err)
        if pool == (2, 2):
            y = ce.conv_epilogue(x, *_epilogue_args(bn), (1, 1))
            assert torch.equal(got.view(torch.int32),
                               F.avg_pool2d(y, pool).view(torch.int32))


@pytest.mark.parametrize('h,w,offset', [(7, 9, 0), (62, 8, 1), (13, 63, 0),
                                        (2, 2, 0), (501, 64, 3)])
def test_cuda_conv_epilogue_scalar_paths(device, h, w, offset):
    """Widths the float4 paths do not take (odd, or W % 8 != 0 when
    pooling) and a base address off 16 bytes."""
    from sed_tpu_torch.ops import conv_epilogue as ce
    bn = _epilogue_bn(5, seed=h, device=device)
    n = 3 * 5 * h * w
    buf = torch.randn(n + offset, device=device,
                      generator=torch.Generator(device=device).manual_seed(w))
    x = buf[offset:].view(3, 5, h, w)
    for pool in ((1, 1), (2, 2)):
        got = ce.conv_epilogue(x, *_epilogue_args(bn), pool)
        want = ce.conv_epilogue_plain(x, *_epilogue_args(bn), pool)
        assert got.shape == want.shape
        assert _rel_err(got, want) <= EPILOGUE_REL_TOL, (h, w, offset, pool)


def test_cuda_conv_epilogue_keeps_nan(device):
    from sed_tpu_torch.ops import conv_epilogue as ce
    bn = _epilogue_bn(4, seed=0, device=device)
    x = torch.randn(2, 4, 10, 16, device=device)
    x[1, 2, 3, 5] = float('nan')
    for pool in ((1, 1), (2, 2)):
        got = ce.conv_epilogue(x, *_epilogue_args(bn), pool)
        want = ce.conv_epilogue_plain(x, *_epilogue_args(bn), pool)
        assert torch.equal(got.isnan(), want.isnan())
        assert got.isnan().sum() == 1


def test_cuda_conv_epilogue_refuses_what_it_does_not_take(device):
    from sed_tpu_torch.ops import conv_epilogue as ce
    bn = _epilogue_bn(4, seed=0, device=device)
    x = torch.randn(2, 4, 10, 16, device=device)
    with pytest.raises(ValueError, match='float32'):
        ce.conv_epilogue(x.double(), *_epilogue_args(bn), (2, 2))
    with pytest.raises(ValueError, match='float32'):
        ce.conv_epilogue(x.bfloat16(), *_epilogue_args(bn), (2, 2))
    with pytest.raises(ValueError, match='contiguous'):
        ce.conv_epilogue(x.transpose(2, 3), *_epilogue_args(bn), (2, 2))
    other = _epilogue_bn(8, seed=0, device=device)
    with pytest.raises(ValueError, match='4 channels'):
        ce.conv_epilogue(x, *_epilogue_args(other), (2, 2))
    with pytest.raises(ValueError, match='no backward'):
        ce.conv_epilogue(x.requires_grad_(), *_epilogue_args(bn), (2, 2))
    # the ConvBlock's dispatch hands the wrapper what it is given: no
    # plain fallback for a tensor the kernel does not take
    from sed_tpu_torch.models import blocks
    with torch.no_grad(), pytest.raises(ValueError, match='contiguous'):
        blocks.epilogue(x.detach().transpose(2, 3), bn.eval(), (2, 2))


@pytest.mark.parametrize('dtype', [None, torch.bfloat16],
                         ids=['fp32', 'bf16'])
def test_cuda_conv_block_epilogue_matches_plain(device, dtype):
    """A ConvBlock in eval mode (fp32 and the bf16 compute dtype, whose
    convolutions return float32) is conv1, the kernel, conv2, the kernel
    (two launches), each epilogue within the relative tolerance of the
    plain version on the same convolution output.  In fp32 the block
    also gives the unfused block's output (the second convolution sees
    the first epilogue's ulps); in bf16 those ulps can flip the rounding
    of conv2's bf16 input, so only the per-epilogue check holds there."""
    from sed_tpu_torch.models import blocks
    from sed_tpu_torch.ops import conv_epilogue as ce
    torch.manual_seed(0)
    block = blocks.ConvBlock(64, 128, dtype=dtype).eval()
    block.bn1 = _epilogue_bn(128, seed=1, device='cpu')
    block.bn2 = _epilogue_bn(128, seed=2, device='cpu')
    block.to(device)
    x = torch.randn(9, 64, 250, 32, device=device)
    with torch.inference_mode():
        launches = ce.conv_epilogue.launches
        got = block(x)
        assert ce.conv_epilogue.launches == launches + 2
        c1 = block.conv1(x)
        y1 = ce.conv_epilogue(c1, *_epilogue_args(block.bn1), (1, 1))
        c2 = block.conv2(y1)
        y2 = ce.conv_epilogue(c2, *_epilogue_args(block.bn2), (2, 2))
        for c, y, bn, pool in ((c1, y1, block.bn1, (1, 1)),
                               (c2, y2, block.bn2, (2, 2))):
            assert c.dtype == torch.float32
            want = ce.conv_epilogue_plain(c, *_epilogue_args(bn), pool)
            assert _rel_err(y, want) <= EPILOGUE_REL_TOL
        unfused = F.avg_pool2d(F.relu(block.bn2(block.conv2(
            F.relu(block.bn1(c1))))), (2, 2))
    assert got.shape == (9, 128, 125, 16)
    assert torch.equal(got, y2)
    if dtype is None:
        assert _rel_err(got, unfused) <= 1e-5


def test_cuda_gru_forward_through_the_epilogue_matches_cpu(device):
    """The bench checkpoint's GRU on 8 clips of 5 s: 8 launches a
    forward, the CPU's framewise and clipwise outputs within 1e-4; a
    training step of the same model launches none."""
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.ops import conv_epilogue as ce
    cfg = config.AUDIO_16K
    wav = torch.from_numpy(make_clips(8, cfg.sample_rate, seconds=5, seed=0))
    out = {}
    for dev in ('cpu', device):
        model = load_npz(CKPT, MODEL, cfg, dev).eval()
        launches = ce.conv_epilogue.launches
        with torch.inference_mode():
            out[dev] = {k: v.cpu() for k, v in model(wav.to(dev)).items()
                        if k in ('framewise_output', 'clipwise_output')}
        assert ce.conv_epilogue.launches == launches + (8 if dev != 'cpu'
                                                        else 0)
    for k, v in out[device].items():
        assert (v - out['cpu'][k]).abs().max() <= 1e-4, k
    model.train()
    launches = ce.conv_epilogue.launches
    loss = model(wav.to(device), spec_augment=False)['clipwise_output'].sum()
    loss.backward()
    assert ce.conv_epilogue.launches == launches


# ---------------------------------------------------------------------------
# csrc/conv3x3.cu: the eval-mode 3x3 convolutions in 3xTF32 on the tensor
# cores.  Error against float64: max |y - y64| over max |y64|.  The kernel
# is fp32-accurate if its error is within CONV_FP32_FACTOR of cuDNN's fp32
# convolution's on the same input, and a lower precision would show: one
# TF32 pass is CONV_TF32_MARGIN times the kernel's error or more.
# ---------------------------------------------------------------------------

CONV_FP32_FACTOR = 4.0
CONV_TF32_MARGIN = 50.0


def _stack_inputs(device, clips: int, seconds: float):
    """The input of each of the bench checkpoint GRU's 8 convolutions on
    ``clips`` bench-corpus clips of ``seconds``: [(conv module, input)]."""
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.models import blocks
    cfg = config.AUDIO_16K
    wav = make_clips(clips, cfg.sample_rate, seconds=int(np.ceil(seconds)),
                     seed=clips)[:, :int(seconds * cfg.sample_rate)]
    wav = torch.from_numpy(np.ascontiguousarray(wav)).to(device)
    model = load_npz(CKPT, MODEL, cfg, device).eval()
    seen, hooks = [], []
    for m in model.modules():
        if isinstance(m, blocks.Conv2d):
            hooks.append(m.register_forward_hook(
                lambda mod, args, out: seen.append((mod, args[0]))))
    with torch.inference_mode():
        model(wav)
    for h in hooks:
        h.remove()
    assert len(seen) == 8
    return seen


def _conv_errors(x, w, rows: int = 4):
    """(kernel, cuDNN fp32, one TF32 pass) error against float64 on the
    first ``rows`` images, each convolution run on the whole batch."""
    from sed_tpu_torch.ops import conv3x3 as cv
    from sed_tpu_torch.ops.logmel_kernel import tf32_round
    launches = cv.conv3x3.launches
    got = cv.conv3x3(x, w)
    assert cv.conv3x3.launches == launches + 1
    lib = F.conv2d(x, w, padding=1)
    one = F.conv2d(tf32_round(x), tf32_round(w), padding=1)
    ref = F.conv2d(x[:rows].double(), w.double(), padding=1)
    return tuple(((y[:rows].double() - ref).abs().max()
                  / ref.abs().max()).item() for y in (got, lib, one))


@pytest.mark.parametrize('clips,seconds', [(32, 5.0), (5, 5.0), (1, 5.0),
                                           (27, 6.0), (9, 6.0), (3, 7.3)],
                         ids=['5s-b32', '5s-b5', '5s-b1', '6s-b27', '6s-b9',
                              '7.3s-b3'])
def test_cuda_conv3x3_fp32_accurate_on_the_serving_paths(device, clips,
                                                         seconds):
    """Each convolution of the stack on bench-corpus activations and the
    bench checkpoint's weights, at the serving paths' batches and lengths
    (5 s at 32, 5 and 1, the 6 s windows' 27 and 9, a ragged 7.3 s): the
    kernel's error against float64 is within CONV_FP32_FACTOR of cuDNN's
    fp32 error and CONV_TF32_MARGIN below one TF32 pass's."""
    for i, (conv, x) in enumerate(_stack_inputs(device, clips, seconds)):
        with torch.inference_mode():
            err, lib, one = _conv_errors(x.contiguous(),
                                         conv.weight.detach())
        print(f'conv {i} {tuple(x.shape)}: kernel {err:.3e} cuDNN fp32 '
              f'{lib:.3e} one TF32 pass {one:.3e}')
        assert err <= CONV_FP32_FACTOR * lib, (i, err, lib)
        assert err * CONV_TF32_MARGIN <= one, (i, err, one)


@pytest.mark.parametrize('shape,offset', [
    ((2, 7, 37, 13), 0),        # ragged T and F, scalar copies
    ((1, 64, 5, 3), 1),         # a base address off 16 bytes
    ((3, 1, 300, 1), 0),        # width 1, the taps as K
    ((2, 20, 9, 60), 0),        # Cin not a multiple of 8
    ((1, 512, 62, 8), 0),       # split K
])
def test_cuda_conv3x3_ragged_shapes(device, shape, offset):
    from sed_tpu_torch.ops import conv3x3 as cv
    gen = torch.Generator(device=device).manual_seed(shape[1])
    n = int(np.prod(shape))
    x = torch.randn(n + offset, device=device, generator=gen)[offset:] \
        .view(shape)
    w = torch.randn(70, shape[1], 3, 3, device=device, generator=gen) \
        / (3 * shape[1] ** 0.5)
    err, lib, one = _conv_errors(x, w, rows=shape[0])
    assert err <= CONV_FP32_FACTOR * lib and err * CONV_TF32_MARGIN <= one, \
        (err, lib, one)


@pytest.mark.parametrize('batch', [1, 5])
def test_cuda_conv3x3_split_k_is_deterministic(device, batch):
    """At batches whose block-4 tiles are fewer than the SMs the kernel
    splits K; two runs give the same bits."""
    from sed_tpu_torch.ops import conv3x3 as cv
    assert cv.splits(batch, 512, 512, 62 * 8, 132) > 1
    gen = torch.Generator(device=device).manual_seed(batch)
    x = torch.randn(batch, 512, 62, 8, device=device, generator=gen).relu()
    w = torch.randn(512, 512, 3, 3, device=device, generator=gen) * 0.02
    planes = cv.weight_planes(w)
    a = cv.conv3x3(x, w, planes)
    b = cv.conv3x3(x, w, planes)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_cuda_conv3x3_launches_eight_a_forward(device):
    """A float32 eval forward of the bench GRU takes the kernel for its
    8 convolutions and none to cuDNN's measured choice; a forward with
    autograd on takes it for none."""
    from sed_tpu_torch.models import blocks
    from sed_tpu_torch.ops import conv3x3 as cv
    launches, calls = cv.conv3x3.launches, blocks.Conv2d.measured_calls
    _bench_forward(device, clips=4)
    assert (cv.conv3x3.launches - launches,
            blocks.Conv2d.measured_calls - calls) == (8, 0)
    _bench_forward(device, clips=4, grad=True)
    assert (cv.conv3x3.launches - launches,
            blocks.Conv2d.measured_calls - calls) == (8, 8)


def test_cuda_conv3x3_refuses_what_it_does_not_take(device):
    from sed_tpu_torch.ops import conv3x3 as cv
    x = torch.randn(2, 4, 10, 16, device=device)
    w = torch.randn(8, 4, 3, 3, device=device)
    with pytest.raises(ValueError, match='contiguous'):
        cv.conv3x3(x.transpose(2, 3), w)
    with pytest.raises(ValueError, match='float32'):
        cv.conv3x3(x.double(), w.double())
    with pytest.raises(ValueError, match='float32'):
        cv.conv3x3(x, w.double())
    with pytest.raises(ValueError, match=r'\(Cout, 4, 3, 3\)'):
        cv.conv3x3(x, torch.randn(8, 5, 3, 3, device=device))
    with pytest.raises(ValueError, match='no backward'):
        cv.conv3x3(x, w.requires_grad_())
    with pytest.raises(ValueError, match='no backward'):
        cv.conv3x3(x.requires_grad_(), w.detach())
    with pytest.raises(ValueError, match='widths'):
        cv.conv3x3(torch.randn(1, 4, 3, 700, device=device), w.detach())
