"""sed_tpu_torch's evaluation path against ``sed_tpu``: the engine's
on-device windowed merging (``predict_clips_windowed``), the
``Evaluator``, and the CLIs ``main_strong`` (``inference_prob``,
``inference_prob_overlap``, ``inference_prob_vote``),
``optimize_thresholds`` and ``predict --sed_thresholds``.

Both model families run at full width on 16 kHz bench-corpus clips:
``Cnn_9layers_Gru_FrameAtt`` on the trained bench checkpoint and
``Cnn_9layers_Transformer_FrameAtt`` on ``transformer_variables``.
Events, submissions, printed metrics and threshold pickles must be
identical; framewise outputs agree to atol 1e-4 (fp32 on both sides,
sums in another order).
"""

import csv
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from sed_tpu.cli import main_strong as jax_main_strong
from sed_tpu.cli import optimize_thresholds as jax_opt
from sed_tpu.cli import predict as jax_predict
from sed_tpu.config import AUDIO_16K, EVAL_SED_PARAMS, LABELS
from sed_tpu.data import audio_io
from sed_tpu.eval.evaluator import Evaluator as JaxEvaluator
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu.serve import engine as jax_engine
from sed_tpu.utils.npz_ckpt import load_variables_npz
from sed_tpu_torch.cli import features as features_cli
from sed_tpu_torch.cli import main_strong, optimize_thresholds, predict
from sed_tpu_torch.compat import bench_weights, from_flax
from sed_tpu_torch.eval.evaluator import Evaluator
from sed_tpu_torch.models.registry import get_model
from sed_tpu_torch.serve import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
GRU = 'Cnn_9layers_Gru_FrameAtt'
TRANSFORMER = 'Cnn_9layers_Transformer_FrameAtt'
ATOL = 1e-4
CFG = AUDIO_16K
sys.path.insert(0, os.path.join(REPO, 'tools'))
from bench_corpus import make_clips  # noqa: E402


@pytest.fixture(scope='module')
def models():
    """family -> (flax model, flax variables, port model on the CPU)."""
    out = {}
    for family, model_type, variables in (
            ('gru', GRU, load_variables_npz(CKPT)),
            ('transformer', TRANSFORMER,
             bench_weights.transformer_variables(seed=0))):
        port = get_model(model_type, CFG)
        from_flax.load_variables(port, variables)
        out[family] = (jax_get_model(model_type, CFG), variables, port)
    return out


@pytest.fixture(scope='module')
def clips10():
    clips, events = make_clips(3, CFG.sample_rate, seconds=10, seed=4,
                               return_events=True)
    return clips, [f'c{i}.wav' for i in range(3)]


FAMILIES = pytest.mark.parametrize('family', ['gru', 'transformer'])
COMBOS = pytest.mark.parametrize('step,window', [(0.5, 6), (1, 5)])


@FAMILIES
@COMBOS
def test_windowed_matches_jax_engine(models, clips10, family, step, window):
    """int16 10 s clips; batch 18 puts 2 clips of 9 windows (0.5, 6) in a
    chunk, so the second chunk is ragged, and 3 clips of 6 windows
    (1, 5) in one."""
    jm, variables, port_model = models[family]
    clips, names = clips10
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
    kw = dict(sample_duration=window, overlap=True, overlap_value=step,
              batch_size=18)
    ref = jax_engine.SedInferenceEngine(jm, variables, CFG, **kw)
    port = engine.SedInferenceEngine(port_model, CFG, 'cpu', **kw)
    got = port.predict_clips_windowed(pcm, names, duration=10.0, step=step)
    assert sum(map(len, got)) > 0
    assert got == ref.predict_clips_windowed(pcm, names, duration=10.0,
                                             step=step)


@FAMILIES
@COMBOS
def test_windowed_matches_host_merge(models, clips10, family, step, window):
    """On-device overlap-add, coverage division and packed decode give
    the events of the host merge (``predict_waveform``)."""
    port = engine.SedInferenceEngine(
        models[family][2], CFG, 'cpu', sample_duration=window, overlap=True,
        overlap_value=step, batch_size=18)
    clips, names = clips10
    got = port.predict_clips_windowed(clips, names, duration=10.0, step=step)
    key = lambda e: (e['onset'], e['event_label'])  # noqa: E731
    for i, name in enumerate(names):
        want = port.predict_waveform(clips[i], name, duration=10.0,
                                     step=step)
        assert sorted(got[i], key=key) == sorted(want, key=key)


def test_windowed_window_counts_and_frames(models):
    """t_win and the merged length mirror sed_tpu: the Transformer's
    windows give 496 / 600 / 696 frames at 5 / 6 / 7 s."""
    for window, t_win in ((5, 496), (6, 600), (7, 696)):
        port = engine.SedInferenceEngine(models['transformer'][2], CFG,
                                         'cpu', sample_duration=window,
                                         batch_size=4)
        assert port._out_frames == t_win
    assert len(engine.window_starts(10.0, 6, True, 0.5)) == 9


def test_windowed_rejects_uint8_wire_and_short_clips(models):
    port = engine.SedInferenceEngine(models['gru'][2], CFG, 'cpu',
                                     sample_duration=5, batch_size=4)
    # a 4-bit wire is half as wide as its clips: without ``clip_samples``
    # its width stands for the decoded length, and the windows do not fit
    with pytest.raises(ValueError, match='do not fit'):
        port.predict_clips_windowed(np.zeros((2, 80000), np.uint8),
                                    ['a', 'b'], duration=10.0, step=1)
    with pytest.raises(ValueError, match='do not fit'):
        port.predict_clips_windowed(np.zeros((2, 120000), np.float32),
                                    ['a', 'b'], duration=10.0, step=1)


def _targets(events, frames=1000):
    target = np.zeros((len(events), len(LABELS)), np.float32)
    strong = np.zeros((len(events), frames, len(LABELS)), np.float32)
    for i, evs in enumerate(events):
        for e in evs:
            k = LABELS.index(e['event_label'])
            target[i, k] = 1
            strong[i, int(e['onset'] * 100):int(e['offset'] * 100), k] = 1
    return target, strong


def _write_reference_csv(path, names, events):
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        for name, evs in zip(names, events):
            for e in evs:
                w.writerow([name, e['onset'], e['offset'], e['event_label']])


@FAMILIES
def test_evaluator_matches_jax(models, tmp_path, family):
    """5 clips of 10 s in batches of 2 (a ragged last batch) from an
    in-memory loader: outputs within 1e-4, AP and segment metrics as
    sed_tpu's, the same submission."""
    jm, variables, port_model = models[family]
    clips, events = make_clips(5, CFG.sample_rate, seconds=10, seed=8,
                               return_events=True)
    names = [f'v{i}.wav' for i in range(5)]
    target, strong = _targets(events)
    loader = [{'audio_name': np.array(names[i:i + 2]),
               'waveform': clips[i:i + 2], 'target': target[i:i + 2],
               'strong_target': strong[i:i + 2]} for i in range(0, 5, 2)]
    ref_csv = str(tmp_path / 'ref.csv')
    _write_reference_csv(ref_csv, names, events)

    want_stats, want = JaxEvaluator(jm, EVAL_SED_PARAMS, batch_size=2) \
        .evaluate(variables['params'], variables['batch_stats'], loader,
                  ref_csv, str(tmp_path / 'jax.tsv'), 100)
    got_stats, got = Evaluator(port_model, 'cpu').evaluate(
        loader, ref_csv, str(tmp_path / 'port.tsv'), 100)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got['audio_name'], want['audio_name'])
    for key in ('framewise_output', 'clipwise_output'):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], atol=ATOL)
    # AP ranks scores: two frames whose outputs differ by less than the
    # framewise tolerance can swap ranks, which moves AP by ~1e-4
    for key in ('clipwise_ap', 'framewise_ap'):
        np.testing.assert_allclose(got_stats[key], want_stats[key],
                                   atol=1e-3)
    assert got_stats['sed_metrics'] == want_stats['sed_metrics']
    assert (tmp_path / 'port.tsv').read_text() == \
        (tmp_path / 'jax.tsv').read_text()


def test_cuda_evaluator_without_cuda_raises(models):
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Evaluator(models['gru'][2], 'cuda')


# ---------------------------------------------------------------------------
# CLIs on a synthetic dataset, sed_tpu's and the port's side by side
# ---------------------------------------------------------------------------

N = 3
SPLITS = ('strong_validation', 'testing')


@pytest.fixture(scope='module')
def dataset_dir(tmp_path_factory):
    """AudioSet-like dataset (the layout of ``test_cli_end_to_end.py``'s
    fixture) of bench-corpus clips with their events as strong labels."""
    root = tmp_path_factory.mktemp('dataset')
    meta = root / 'metadata'
    (meta / 'strong').mkdir(parents=True)
    for s, split in enumerate(SPLITS):
        clips, events = make_clips(N, CFG.sample_rate, seconds=10,
                                   seed=30 + s, return_events=True)
        (root / split).mkdir()
        weak, strong = [], []
        for i, (audio, evs) in enumerate(zip(clips, events)):
            ytid = f'{split}{i}'
            name = f'{ytid}_0.wav'
            audio_io.save_wav(str(root / split / name), audio,
                              CFG.sample_rate)
            labels = ','.join(sorted({e['event_label'] for e in evs}))
            weak.append([ytid, '0.000', '10.000', labels, '/m/x'])
            strong += [[name, e['onset'], e['offset'], e['event_label']]
                       for e in evs]
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


MODEL_ARGS = ['--model_type', TRANSFORMER, '--batch_size', '4',
              '--audio_16k']


@pytest.fixture(scope='module')
def workspaces(dataset_dir, tmp_path_factory, models):
    """Two workspaces, one per package, each with the packed splits and
    the Transformer's weights as a reference-layout .pth at the
    workspace's checkpoint path."""
    from sed_tpu.utils.paths import Workspace
    jax_ws = str(tmp_path_factory.mktemp('ws_jax'))
    for split in SPLITS:
        features_cli.main(['pack_audio_files_to_hdf5', '--dataset_dir',
                           dataset_dir, '--workspace', jax_ws, '--data_type',
                           split, '--audio_16k'])
    state = from_flax.state_dict_from_variables(models['transformer'][1])
    for name in ('att', 'cla'):
        key = f'att_block.{name}.weight'
        state[key] = state[key][:, :, None]          # Conv1d (O, I, 1)
    pth = Workspace(root=jax_ws, model_type=TRANSFORMER, batch_size=4,
                    augmentation='none').torch_checkpoint_path('logmel',
                                                              '16k')
    os.makedirs(os.path.dirname(pth))
    torch.save({'iteration': 1000, 'model': state}, pth)
    port_ws = str(tmp_path_factory.mktemp('ws_port'))
    shutil.copytree(jax_ws, port_ws, dirs_exist_ok=True)
    return jax_ws, port_ws


def _metric_lines(text):
    return [line for line in text.splitlines() if line.startswith('Micro')]


def _run_both(capsys, dataset_dir, workspaces, jax_fn, port_fn, jax_parser,
              port_parser, mode, extra=()):
    """Run a mode of both CLIs; returns [(result, printed metric lines,
    workspace)] for sed_tpu and the port."""
    out = []
    for fn, parser, ws, tail in (
            (jax_fn, jax_parser, workspaces[0], []),
            (port_fn, port_parser, workspaces[1], ['--device', 'cpu'])):
        capsys.readouterr()
        args = parser().parse_args([mode, '--dataset_dir', dataset_dir,
                                    '--workspace', ws, *MODEL_ARGS,
                                    *extra, *tail])
        result = fn(args)
        out.append((result, _metric_lines(capsys.readouterr().out), ws))
    return out


def _leaf(ws, kind, name=''):
    from sed_tpu.utils.paths import Workspace
    return os.path.join(Workspace(root=ws, model_type=TRANSFORMER,
                                  batch_size=4, augmentation='none')
                        .dir(kind), name)


def test_cli_inference_prob_matches_jax(capsys, dataset_dir, workspaces):
    (want, want_lines, jws), (got, got_lines, pws) = _run_both(
        capsys, dataset_dir, workspaces, jax_main_strong.inference_prob,
        main_strong.inference_prob, jax_main_strong.get_parser,
        main_strong.get_parser, 'inference_prob')
    assert len(got_lines) == 4 and got_lines == want_lines
    assert got['sed_metrics'] == want['sed_metrics']
    sub = ('_tmp_submission', '_submission.csv')
    assert open(_leaf(pws, *sub)).read() == open(_leaf(jws, *sub)).read()
    pkl = ('predictions', 'test_predictions_logmel_16k.pkl')
    with open(_leaf(jws, *pkl), 'rb') as f:
        want_pred = pickle.load(f)
    with open(_leaf(pws, *pkl), 'rb') as f:
        got_pred = pickle.load(f)
    assert got_pred.keys() == want_pred.keys()
    for key in ('framewise_output', 'clipwise_output'):
        assert got_pred[key].shape == want_pred[key].shape == \
            ((N, 1000, 25) if key == 'framewise_output' else (N, 25))
        np.testing.assert_allclose(got_pred[key], want_pred[key], atol=ATOL)
    for key in ('audio_name', 'target', 'strong_target'):
        np.testing.assert_array_equal(got_pred[key], want_pred[key])


@pytest.mark.parametrize('mode', ['inference_prob_overlap',
                                  'inference_prob_vote'])
def test_cli_windowed_modes_match_jax(capsys, dataset_dir, workspaces, mode):
    """All five [overlap_value, window] combinations: the same segment
    metrics, printed lines and (last) submission."""
    (want, want_lines, jws), (got, got_lines, pws) = _run_both(
        capsys, dataset_dir, workspaces, getattr(jax_main_strong, mode),
        getattr(main_strong, mode), jax_main_strong.get_parser,
        main_strong.get_parser, mode)
    assert list(got) == [tuple(c) for c in main_strong.PARAM_COMBINATIONS]
    assert got == want
    assert len(got_lines) == 10 and got_lines == want_lines
    sub = ('_tmp_submission', '_submission.csv')
    text = open(_leaf(pws, *sub)).read()
    assert text and text == open(_leaf(jws, *sub)).read()


def test_cli_optimize_thresholds_then_predict_match_jax(
        capsys, dataset_dir, workspaces, tmp_path):
    """``optimize_sed_thresholds --epochs 2`` writes the same threshold
    pickle; ``predict --sed_thresholds`` with the Transformer (the
    reference's configuration 2) then writes sed_tpu's XML."""
    (want, _, jws), (got, _, pws) = _run_both(
        capsys, dataset_dir, workspaces, jax_opt.optimize_sed_thresholds,
        optimize_thresholds.optimize_sed_thresholds, jax_opt.get_parser,
        optimize_thresholds.get_parser, 'optimize_sed_thresholds',
        extra=['--epochs', '2'])
    assert got[0] == want[0] and list(got[1]) == list(want[1])
    thr = ('opt_thresholds', 'best_logmel_16k.sed.valid.pkl')
    with open(_leaf(jws, *thr), 'rb') as f:
        want_thr = pickle.load(f)
    with open(_leaf(pws, *thr), 'rb') as f:
        got_thr = pickle.load(f)
    assert got_thr == want_thr

    in_dir = tmp_path / 'in'
    in_dir.mkdir()
    audio_io.save_wav(str(in_dir / 'long.wav'),
                      make_clips(1, 16000, seconds=12, seed=3)[0], 16000)
    common = ['--model_type', TRANSFORMER, '--batch_size', '4',
              '--audio_16k', '--overlap', '--sed_thresholds',
              '--input_dir', str(in_dir)]
    jax_predict.main(['predict', '--workspace', jws, *common])
    predict.main(['predict', '--workspace', pws, *common, '--device', 'cpu'])
    xml = os.path.join('predict_results', 'long.xml')
    written = open(os.path.join(pws, xml)).read()
    assert '<AudioDoc name="long.wav">' in written
    assert written == open(os.path.join(jws, xml)).read()


def test_cli_exits_without_checkpoint_or_for_train(tmp_path, dataset_dir):
    """No checkpoint exits; ``train`` (ported since) asks for the card by
    default, which raises on a host without CUDA; an Orbax checkpoint at
    the workspace's stem exits naming the export."""
    base = ['--dataset_dir', dataset_dir, '--workspace', str(tmp_path),
            *MODEL_ARGS]
    with pytest.raises(SystemExit, match='random'):
        main_strong.main(['inference_prob', *base, '--device', 'cpu'])
    assert main_strong.get_parser().parse_args(['train', *base]).device == \
        'cuda'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            main_strong.main(['train', *base])
    orbax = _leaf(str(tmp_path), 'checkpoints', 'best_logmel_16k')
    os.makedirs(orbax)
    open(os.path.join(orbax, '_CHECKPOINT_METADATA'), 'w').close()
    with pytest.raises(SystemExit, match='save_variables_npz'):
        optimize_thresholds.main(['optimize_sed_thresholds', *base,
                                  '--device', 'cpu'])
    # --device defaults to the card
    assert main_strong.get_parser().parse_args(
        ['inference_prob', *base]).device == 'cuda'
