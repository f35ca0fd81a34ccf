"""The gammatone feature path of sed_tpu_torch against ``sed_tpu``
(``BASELINE.json`` ``configs[3]``: ``--feature_type gamma`` at 8, 16 and
32 kHz): HDF5 packing, the batched gammatonegram, a joint train step on
packed features, the training loader, the refusals of the paths that
feed waveforms, checkpoints, and the port's CLIs end to end.

Inputs are bench-corpus clips made with numpy from a seed.  Packed
gammatone features are int16 dB values (``fft_gtgram_db(...).astype(
np.int16)``, which truncates) that reach the model divided by 32767, as
in ``sed_tpu`` and the reference; ``bn0`` absorbs the scale.  Tolerances
are stated in each test.
"""

import argparse
import csv
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sed_tpu import config as jax_config
from sed_tpu import losses as jax_losses
from sed_tpu.data import hdf5_pack as jax_pack
from sed_tpu.dsp import gammatone as jax_gt
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu.models.zoo import CnnSed as JaxCnnSed
from sed_tpu.serve import engine as jax_engine
from sed_tpu.train.state import SedTrainState
from sed_tpu.train.step import make_train_step as jax_make_train_step
from sed_tpu_torch import config, losses
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.cli import common, features, main_strong, predict
from sed_tpu_torch.compat import from_flax
from sed_tpu_torch.data import audio_io, hdf5_pack
from sed_tpu_torch.dsp import gammatone as gt
from sed_tpu_torch.models.registry import get_model
from sed_tpu_torch.models.zoo import CnnSed
from sed_tpu_torch.serve.engine import SedInferenceEngine
from sed_tpu_torch.train import checkpoint as ckpt
from sed_tpu_torch.train.state import create_train_state
from sed_tpu_torch.train.step import make_train_step
from sed_tpu_torch.utils.paths import Workspace

QUALITIES = ('8k', '16k', '32k')
CFGS = pytest.mark.parametrize('quality', QUALITIES)
NARROW = dict(conv_channels=(8, 16, 16, 32), head='att', gru_hidden=16,
              pad_to_roundup=True)
LR = 1e-3
N_CLIPS = 4
SPLITS = ('weak_training', 'strong_training', 'strong_validation',
          'testing')
MODEL = 'Cnn_9layers_FrameAvg'
CLI_ARGS = ['--model_type', MODEL, '--batch_size', '2', '--audio_16k',
            '--feature_type', 'gamma']


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes on one
    host, and torch's default of one thread per core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _features(clips: np.ndarray, cfg) -> np.ndarray:
    """Packed gammatone rows: int16 (N, mel_bins, frames)."""
    return np.stack([gt.fft_gtgram_db(c, cfg).astype(np.int16)
                     for c in clips])


# ---------------------------------------------------------------------------
# a dataset in the reference's layout, 16 kHz wavs of 10 s
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def dataset_dir(tmp_path_factory):
    """``N_CLIPS`` bench-corpus clips of 10 s a split with weak and strong
    labels; the strong_training csv also lists a clip whose wav is
    missing (packed as a zero clip with a warning)."""
    root = tmp_path_factory.mktemp('gamma_dataset')
    meta = root / 'metadata'
    (meta / 'strong').mkdir(parents=True)
    for s, split in enumerate(SPLITS):
        clips, events = make_clips(N_CLIPS, 16000, seconds=10, seed=70 + s,
                                   return_events=True)
        (root / split).mkdir()
        weak, strong = [], []
        for i, (audio, evs) in enumerate(zip(clips, events)):
            ytid = f'{split}{i}'
            name = f'{ytid}_0.wav'
            audio_io.save_wav(str(root / split / name), audio, 16000)
            weak.append([ytid, '0.000', '10.000',
                         ','.join(sorted({e['event_label'] for e in evs})),
                         '/m/x'])
            strong += [[name, e['onset'], e['offset'], e['event_label']]
                       for e in evs]
        if split == 'strong_training':
            weak.append(['missing', '0.000', '10.000', config.LABELS[0],
                         '/m/x'])
        if split == 'testing':
            weak_path = meta / 'testing_set.csv'
            strong_path = meta / 'groundtruth_strong_label_testing_set.csv'
        else:
            weak_path = meta / 'strong' / f'{split}_set.csv'
            strong_path = (meta / 'strong' /
                           f'groundtruth_strong_label_{split}_set.csv')
        for path, rows in ((weak_path, weak), (strong_path, strong)):
            with open(path, 'w', newline='') as f:
                csv.writer(f).writerows(rows)
    return str(root)


def _pack(module, dataset_dir, out, cfg, feature_type):
    split = 'strong_training'
    return module.pack_audio_files_to_hdf5(
        audios_dir=os.path.join(dataset_dir, split),
        csv_path=os.path.join(dataset_dir, 'metadata', 'strong',
                              f'{split}_set.csv'),
        packed_hdf5_path=out, data_type=split, cfg=cfg,
        feature_type=feature_type,
        strong_csv_path=os.path.join(
            dataset_dir, 'metadata', 'strong',
            f'groundtruth_strong_label_{split}_set.csv'))


@pytest.mark.parametrize('feature_type', ['logmel', 'gamma'])
@CFGS
def test_packed_hdf5_equals_sed_tpu(dataset_dir, tmp_path, quality,
                                    feature_type, caplog):
    """The port's ``pack_audio_files_to_hdf5`` writes sed_tpu's file:
    the same datasets, dtypes, shapes and values, bit for bit (the
    16 kHz wavs resampled to the quality by ``load_audio``; a missing wav
    packed as zeros with a warning)."""
    import h5py
    cfg = config.QUALITY[quality]
    got = str(tmp_path / hdf5_pack.hdf5_filename(
        'strong_training', feature_type, cfg.name))
    want = str(tmp_path / 'jax' / jax_pack.hdf5_filename(
        'strong_training', feature_type, cfg.name))
    with caplog.at_level(logging.WARNING):
        _pack(hdf5_pack, dataset_dir, got, cfg, feature_type)
    assert any('missing_0.wav' in r.getMessage() for r in caplog.records)
    _pack(jax_pack, dataset_dir, want, jax_config.QUALITY[quality],
          feature_type)
    assert os.path.basename(got) == os.path.basename(want)
    with h5py.File(got, 'r') as g, h5py.File(want, 'r') as w:
        assert sorted(g) == sorted(w) == ['audio_name', 'strong_target',
                                          'target', 'waveform']
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert np.array_equal(g[k][()], w[k][()]), k
        n = N_CLIPS + 1
        if feature_type == 'gamma':
            assert g['waveform'].shape == (n, 64, 994)
            assert g['waveform'].dtype == np.int16
            assert (g['waveform'][-1] == g['waveform'][-1, 0, 0]).all()
        else:
            assert g['waveform'].shape == (n, cfg.audio_samples)
            assert not g['waveform'][-1].any()
        assert g['audio_name'].dtype == np.dtype('S80')
        assert g['strong_target'].shape == (n, 1000, 25)


def test_packed_gamma_truncates_toward_zero():
    """``astype(np.int16)`` truncates the float64 dB values (it does not
    round): a clip of +-0.3 noise packs to values in about [-30, -7]."""
    cfg = config.AUDIO_16K
    x = np.random.RandomState(5).uniform(-0.3, 0.3, cfg.audio_samples)
    db = gt.fft_gtgram_db(x, cfg)
    packed = db.astype(np.int16)
    assert np.array_equal(packed, np.trunc(db).astype(np.int16))
    assert not np.array_equal(packed, np.round(db).astype(np.int16))
    assert -40 < packed.min() and packed.max() < 0


# ---------------------------------------------------------------------------
# the batched gammatonegram
# ---------------------------------------------------------------------------

@CFGS
def test_fft_gtgram_batch_matches_sed_tpu_and_float64(quality):
    """``fft_gtgram_batch`` on a CPU tensor against sed_tpu's jnp one and
    the numpy float64 ``fft_gtgram``, at a length whose last frame ends
    exactly on the clip (the trailing all-zero column) and at one that
    does not: the same shape and zero column; values within 5e-6 of each
    clip's largest against float64 and against sed_tpu (float32 both,
    sums in other orders; measured up to 1.8e-6 and 2.1e-6, sed_tpu's
    own 2.3e-6 from float64)."""
    cfg = config.QUALITY[quality]
    args = (cfg.sample_rate, cfg.window_size / cfg.sample_rate,
            cfg.hop_size / cfg.sample_rate, cfg.mel_bins, cfg.fmin)
    nfft, _, nhop = gt._fft_gtgram_geometry(*args[:3])
    for samples, zero_col in ((nfft + 150 * nhop, True),
                              (nfft + 150 * nhop + nhop // 2, False)):
        x = make_clips(3, cfg.sample_rate, seconds=3, seed=9)[:, :samples]
        got = gt.fft_gtgram_batch(torch.from_numpy(x), *args).numpy()
        want = np.asarray(jax_gt.fft_gtgram_batch(jnp.asarray(x), *args))
        assert got.shape == want.shape == (3, cfg.mel_bins, 151)
        for i in range(3):
            gold = gt.fft_gtgram(x[i].astype(np.float64), *args)
            assert gold.shape == got[i].shape
            top = np.abs(gold).max()
            assert np.abs(got[i] - gold).max() <= 5e-6 * top
            assert np.abs(got[i] - want[i]).max() <= 5e-6 * top
            assert (got[i, :, -1] == 0).all() == zero_col
            assert (gold[:, -1] == 0).all() == zero_col


# ---------------------------------------------------------------------------
# one joint train step on packed gammatone features
# ---------------------------------------------------------------------------

def _gamma_batches(cfg, seed=0, n_weak=4, n_strong=2):
    """Weak and strong batches of packed int16 features of 1 s clips (94
    frames at every rate) with mixup lambdas."""
    rng = np.random.RandomState(seed)
    clips = make_clips(n_weak + n_strong, cfg.sample_rate, seconds=1,
                       seed=seed)
    feats = _features(clips, cfg)
    weak = {'waveform': feats[:n_weak],
            'target': (rng.rand(n_weak, 25) > 0.7).astype(np.float32)}
    strong = {'waveform': feats[n_weak:],
              'strong_target': (rng.rand(n_strong, 100, 25) > 0.8)
              .astype(np.float32)}
    for b in (weak, strong):
        lam = rng.rand(len(b['waveform']) // 2)
        b['mixup_lambda'] = np.stack([lam, 1 - lam], 1).reshape(-1) \
            .astype(np.float32)
    return weak, strong


def _t(batch, dtype=None):
    out = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    if dtype is not None:
        out['waveform'] = out['waveform'].to(dtype) / 32767.0
    return out


def _grads(pm, weak, strong, dtype):
    """The port's gradients of one joint step without the update;
    float64 runs the model on the features divided in float64."""
    from unittest import mock
    pm = pm.to(dtype)
    state = create_train_state(pm, LR, fresh=False)
    state.optimizer.step = lambda *a: None
    step = make_train_step(pm, state.optimizer, losses.clip_bce,
                           losses.frame_bce, mixup=True, timeshift=False,
                           spec_augment=False)
    if dtype == torch.float32:
        metrics = step(_t(weak), [_t(strong)], torch.Generator())
    else:
        with mock.patch('sed_tpu_torch.ops.wire.dequant_wire',
                        lambda w, s=None: w):
            metrics = step(_t(weak, dtype), [_t(strong, dtype)],
                           torch.Generator())
    return ({k: p.grad.double().clone() for k, p in pm.named_parameters()},
            metrics['loss'].item())


@CFGS
def test_one_joint_step_on_gamma_matches_sed_tpu(quality):
    """One joint step (mixup on, SpecAugment and timeshift off) of a
    narrow GRU model on packed int16 features, both sides from the same
    weights: loss within rtol 1e-5 of sed_tpu's; each gradient within
    1e-5 of its tensor's max |g| of a float64 evaluation, and within 1e-4
    of it of sed_tpu's once sed_tpu's own float32 error (at most 2e-2) is
    allowed for, with the float32 noise floor of 2e-7 of the model's
    largest gradient: the bounds of
    ``test_torch_train.py::test_one_joint_step_gradients_match_sed_tpu``."""
    cfg = config.QUALITY[quality]
    weak, strong = _gamma_batches(cfg, seed=3)
    t = weak['waveform'].shape[-1]
    jm = JaxCnnSed(cfg=jax_config.QUALITY[quality], feature_type='gamma',
                   temporal='gru', **NARROW)
    variables = jax.tree.map(np.asarray, dict(jax.jit(
        lambda k: jm.init({'params': k}, jnp.zeros((1, cfg.mel_bins, t)),
                          train=False))(jax.random.PRNGKey(0))))
    jstate = SedTrainState.create(
        apply_fn=jm.apply, params=variables['params'],
        batch_stats=variables['batch_stats'],
        tx=optax.amsgrad(LR, b1=0.9, b2=0.999, eps=1e-8))
    jstep = jax_make_train_step(jm, jax_losses.clip_bce,
                                jax_losses.frame_bce, mixup=True,
                                timeshift=False, spec_augment=False,
                                donate=False)
    jstate, jmetrics = jstep(jstate, weak, strong, jax.random.PRNGKey(0))
    mu = jax.tree.map(np.asarray, jstate.opt_state[0].mu)
    jgrad = {k: v.double() / float(np.float32(0.1)) for k, v in
             from_flax.state_dict_from_variables({'params': mu}).items()}

    def port():
        return from_flax.load_variables(
            CnnSed(cfg, feature_type='gamma', temporal='gru', **NARROW),
            variables)
    grad, loss = _grads(port(), weak, strong, torch.float32)
    exact, _ = _grads(port(), weak, strong, torch.float64)
    jloss = float(jmetrics['loss'])
    assert np.isfinite(loss) and abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert grad.keys() == jgrad.keys()
    top = max(v.abs().max() for v in exact.values())
    floor = 2e-7 * top
    for k, g in grad.items():
        j = jgrad[k]
        scale = exact[k].abs().max()
        assert (g - exact[k]).abs().max() <= 1e-5 * scale + floor, k
        own = (j - exact[k]).abs().max()
        assert own <= 2e-2 * scale + floor, k
        assert (g - j).abs().max() <= 1e-4 * scale + floor + own, k


def test_gamma_features_reach_the_model_divided_by_32767():
    """The reference quirk kept: a packed int16 batch reaches the model as
    ``int16 / 32767`` through the train step's ``dequant_wire`` and the
    evaluator's, so the int16 features and their float division give the
    same outputs, and ``bn0`` sees values of about 1e-3."""
    from sed_tpu_torch.eval.evaluator import forward_all
    cfg = config.AUDIO_16K
    weak, _ = _gamma_batches(cfg, seed=4)
    pm = CnnSed(cfg, feature_type='gamma', temporal='gru', **NARROW).eval()
    seen = []
    pm.bn0.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    loader = [{'audio_name': np.array(['a', 'b', 'c', 'd']),
               'waveform': weak['waveform']}]
    divided = torch.from_numpy(weak['waveform']).float() / 32767.0
    out = forward_all(pm, loader, 'cpu', return_target=False)
    want = forward_all(pm, [dict(loader[0], waveform=divided.numpy())],
                       'cpu', return_target=False)
    assert np.array_equal(out['framewise_output'], want['framewise_output'])
    assert torch.equal(seen[0], divided)
    assert 1e-4 < seen[0].abs().max() < 2e-3


# ---------------------------------------------------------------------------
# the port's CLIs on a gamma workspace
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def gamma_ws(dataset_dir, tmp_path_factory):
    """The four splits packed as gamma at 16 kHz by the port's CLI."""
    ws = str(tmp_path_factory.mktemp('gamma_ws'))
    for split in SPLITS:
        features.main(['pack_audio_files_to_hdf5', '--dataset_dir',
                       dataset_dir, '--workspace', ws, '--data_type', split,
                       '--audio_16k', '--feature_type', 'gamma'])
    return ws


def test_training_loader_on_gamma_equals_sed_tpu(gamma_ws):
    """The train stream (int16 rows as shipped) and the evaluation stream
    (divided by 32767) of a packed gamma file: sed_tpu's batches, in the
    same order, bit for bit."""
    from sed_tpu.data.dataset import (AudiosetDataset as JaxDataset,
                                      DataLoader as JaxLoader,
                                      TestSampler as JaxTestSampler,
                                      TrainSampler as JaxTrainSampler)
    from sed_tpu_torch.data.dataset import (AudiosetDataset, DataLoader,
                                            TestSampler, TrainSampler)
    path = os.path.join(gamma_ws, 'hdf5s', 'strong_training_gamma_16k.h5')
    for kw, sampler, jsampler, n in (
            (dict(dequantize=False, wire='int16'), TrainSampler,
             JaxTrainSampler, 4),
            ({}, TestSampler, JaxTestSampler, 3)):
        got = iter(DataLoader(AudiosetDataset(**kw), sampler(path, 2),
                              num_workers=2))
        want = iter(JaxLoader(JaxDataset(**kw), jsampler(path, 2),
                              num_workers=2))
        for _ in range(n):
            g, w = next(got), next(want)
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                assert np.array_equal(g[k], w[k]), k
            assert g['waveform'].shape[1:] == (64, 994)


def test_train_wire_refusal_leaves_no_workspace(tmp_path, dataset_dir):
    """``train --feature_type gamma --train_wire q6`` exits before any
    workspace directory exists, as sed_tpu's does."""
    ws = tmp_path / 'ws'
    with pytest.raises(SystemExit, match='train_wire'):
        main_strong.main(['train', '--dataset_dir', dataset_dir,
                          '--workspace', str(ws), *CLI_ARGS,
                          '--train_wire', 'q6', '--device', 'cpu'])
    assert not ws.exists()


def test_cli_pack_train_inference_on_gamma(dataset_dir, gamma_ws,
                                           tmp_path):
    """pack (the fixture) -> ``main_strong train`` (2 iterations, an
    evaluation after the first saves ``iter_1.pth`` + ``BEST``) ->
    ``inference_prob`` on the gamma HDF5s, on the CPU: the checkpoint is
    found under ``best_gamma_16k``, the metrics are finite and the
    prediction pickle holds the model's 992 frames a clip."""
    import pickle
    import shutil
    ws = str(tmp_path / 'ws')
    shutil.copytree(gamma_ws, ws)
    state = main_strong.main(['train', '--dataset_dir', dataset_dir,
                              '--workspace', ws, *CLI_ARGS,
                              '--stop_iteration', '2', '--eval_interval',
                              '1', '--device', 'cpu'])
    assert state.step == 2 and state.model.feature_type == 'gamma'
    w = Workspace(root=ws, model_type=MODEL, batch_size=2,
                  augmentation='none')
    lineage = w.checkpoint_path('gamma', '16k')
    assert os.path.basename(lineage) == 'best_gamma_16k'
    assert ckpt.saved_iterations(lineage) == [1]
    stats = main_strong.main(['inference_prob', '--dataset_dir',
                              dataset_dir, '--workspace', ws, *CLI_ARGS,
                              '--device', 'cpu'])
    er = stats['sed_metrics']['overall']['error_rate']['error_rate']
    assert np.isfinite(er)
    with open(w.predictions_path('test_predictions_gamma_16k.pkl'),
              'rb') as f:
        out = pickle.load(f)
    # 994 frames pooled to 124, x8: Cnn_9layers_FrameAvg keeps 992
    assert out['framewise_output'].shape == (N_CLIPS, 992, 25)


# ---------------------------------------------------------------------------
# serving feeds waveforms: a gamma model is refused up front
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_gamma_model():
    jm = jax_get_model(MODEL, jax_config.AUDIO_16K, feature_type='gamma')
    variables = jax.jit(lambda k: jm.init(
        {'params': k}, jnp.zeros((1, 64, 994)), train=False))(
            jax.random.PRNGKey(0))
    return jm, jax.tree.map(np.asarray, dict(variables))


def test_sed_tpu_engine_fails_on_a_gamma_model(jax_gamma_model):
    """sed_tpu's ``SedInferenceEngine`` (hence its ``predict``,
    ``inference_prob_overlap`` / ``_vote`` and ``StreamingSed``, which
    all build one) fails on a gamma model: it runs a waveform through the
    forward, which transposes it as a feature matrix."""
    jm, variables = jax_gamma_model
    with pytest.raises(ValueError, match='axis 2 is out of bounds'):
        jax_engine.SedInferenceEngine(jm, variables, jax_config.AUDIO_16K,
                                      batch_size=2)


def test_port_refuses_a_gamma_model_where_sed_tpu_fails(tmp_path,
                                                        dataset_dir):
    """The port refuses it up front, naming the feature type: the engine
    (so ``StreamingSed`` too) raises ValueError, ``predict`` and the
    windowed ``main_strong`` modes exit before a checkpoint is read."""
    cfg = config.AUDIO_16K
    pm = get_model(MODEL, cfg, feature_type='gamma')
    with pytest.raises(ValueError, match="feature_type='gamma'"):
        SedInferenceEngine(pm, cfg, 'cpu')
    base = ['--workspace', str(tmp_path), *CLI_ARGS, '--device', 'cpu']
    with pytest.raises(SystemExit, match='--feature_type gamma'):
        predict.main(['predict', *base, '--input_dir', str(tmp_path)])
    for mode in ('inference_prob_overlap', 'inference_prob_vote'):
        with pytest.raises(SystemExit, match='--feature_type gamma'):
            main_strong.main([mode, '--dataset_dir', dataset_dir, *base])
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match='unsupported feature_type: cqt'):
        get_model(MODEL, cfg, feature_type='cqt')


# ---------------------------------------------------------------------------
# checkpoints of a gamma model
# ---------------------------------------------------------------------------

def test_gamma_checkpoints_bridge_both_ways(tmp_path, jax_gamma_model):
    """sed_tpu's gamma variables load into the port's gamma model leaf by
    leaf (the same tensors as log-mel's) and give sed_tpu's outputs
    within 1e-5; the trainer's ``iter_N.pth`` of the port's gamma model
    is read by the port (``load_checkpoint``) and by
    ``sed_tpu.compat.torch_loader`` into flax variables whose gamma
    forward gives the port's outputs within 1e-5; a reference ``.pth``
    holding ``gamma_extractor.`` tensors loads with them skipped."""
    from sed_tpu.compat import torch_loader as jax_loader
    cfg = config.AUDIO_16K
    jm, variables = jax_gamma_model
    x = (_features(make_clips(2, 16000, seconds=10, seed=8), cfg)
         / 32767.0).astype(np.float32)
    pm = from_flax.load_variables(get_model(MODEL, cfg, feature_type='gamma'),
                                  variables)
    logmel = from_flax.load_variables(get_model(MODEL, cfg), variables)
    assert pm.state_dict().keys() == logmel.state_dict().keys()
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got['framewise_output'].numpy(),
                               np.asarray(want['framewise_output']),
                               rtol=1e-5, atol=1e-5)

    state = create_train_state(pm, LR, torch.Generator().manual_seed(1))
    path = str(tmp_path / 'iter_0.pth')
    ckpt.save_checkpoint(path, state)
    loaded = from_flax.load_checkpoint(path, MODEL, cfg, 'cpu',
                                       feature_type='gamma')
    assert loaded.feature_type == 'gamma'
    obj = torch.load(path, weights_only=True)
    jvars = jax_loader.state_dict_to_variables(
        {k: v.numpy() for k, v in obj['model'].items()})
    with torch.inference_mode():
        ref = state.model.eval()(torch.from_numpy(x))
        again = loaded(torch.from_numpy(x))
    jout = jm.apply(jvars, jnp.asarray(x), train=False)
    for k in ('framewise_output', 'clipwise_output'):
        assert torch.equal(again[k], ref[k]), k
        np.testing.assert_allclose(np.asarray(jout[k]), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)

    extra = dict(obj['model'])
    extra['gamma_extractor.weights'] = torch.zeros(64, 513)
    torch.save({'iteration': 0, 'model': extra}, str(tmp_path / 'ref.pth'))
    ref_loaded = from_flax.load_checkpoint(str(tmp_path / 'ref.pth'), MODEL,
                                           cfg, 'cpu', feature_type='gamma')
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, ref_loaded.state_dict()[k]), k


def test_checkpoint_path_finds_the_gamma_lineage(tmp_path):
    """``cli/common.checkpoint_path`` resolves a gamma model's lineage
    under ``best_gamma_<quality>``, never the log-mel one."""
    cfg = config.AUDIO_16K
    ws = Workspace(root=str(tmp_path), model_type=MODEL, batch_size=2)
    state = create_train_state(get_model(MODEL, cfg, feature_type='gamma'),
                               LR, torch.Generator().manual_seed(0))
    saved = ckpt.save_best_checkpoint(ws.checkpoint_path('gamma', cfg.name,
                                                         create=True), state)
    args = argparse.Namespace(checkpoint=None, feature_type='gamma',
                              model_type=MODEL)
    assert common.checkpoint_path(args, cfg, ws) == saved
    with pytest.raises(SystemExit, match='no checkpoint'):
        common.checkpoint_path(argparse.Namespace(
            checkpoint=None, feature_type='logmel', model_type=MODEL),
            cfg, ws)
