"""The port's training CLIs on the CPU: ``main_strong train`` and ``main
train`` save the step-tagged lineage, resume at exactly N, refuse an
unsaved N, and ``inference_prob`` runs on what they saved; the saved
``.pth`` is the reference's layout, which ``sed_tpu``'s own loader reads
into flax variables that give the port model's outputs within 1e-5.

The dataset is ``tests/test_torch_eval.py``'s layout (bench-corpus clips
of 10 s with their events as strong labels), packed with
``sed_tpu_torch.cli.features``; the model is the full-width
``Cnn_9layers_FrameAvg`` at batch 2, as ``sed_tpu``'s own CLI test uses.
"""

import argparse
import csv
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from sed_tpu.config import AUDIO_16K
from sed_tpu.data import audio_io
from sed_tpu_torch.cli import features as features_cli
from sed_tpu_torch.cli import common, main, main_strong
from sed_tpu_torch.train import checkpoint as ckpt
from sed_tpu_torch.utils.paths import Workspace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
from bench_corpus import make_clips  # noqa: E402

CFG = AUDIO_16K
MODEL = 'Cnn_9layers_FrameAvg'
SPLITS = {'weak_training': 2, 'strong_training': 2, 'strong_validation': 3,
          'testing': 3, 'training': 2}
ARGS = ['--model_type', MODEL, '--batch_size', '2', '--audio_16k']


@pytest.fixture(scope='module')
def dataset_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp('dataset')
    meta = root / 'metadata'
    (meta / 'strong').mkdir(parents=True)
    for s, (split, n) in enumerate(SPLITS.items()):
        clips, events = make_clips(n, CFG.sample_rate, seconds=10,
                                   seed=60 + s, return_events=True)
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
        if split in ('testing', 'training'):
            weak_path = meta / f'{split}_set.csv'
            strong_path = meta / f'groundtruth_strong_label_{split}_set.csv'
        else:
            weak_path = meta / 'strong' / f'{split}_set.csv'
            strong_path = (meta / 'strong' /
                           f'groundtruth_strong_label_{split}_set.csv')
        for path, rows in ((weak_path, weak), (strong_path, strong)):
            with open(path, 'w', newline='') as f:
                csv.writer(f).writerows(rows)
    return str(root)


@pytest.fixture(scope='module')
def packed(dataset_dir, tmp_path_factory):
    ws = str(tmp_path_factory.mktemp('packed'))
    for split in SPLITS:
        features_cli.main(['pack_audio_files_to_hdf5', '--dataset_dir',
                           dataset_dir, '--workspace', ws, '--data_type',
                           split, '--audio_16k'])
    return ws


def _copy(packed, tmp_path_factory, name):
    ws = str(tmp_path_factory.mktemp(name))
    shutil.copytree(packed, ws, dirs_exist_ok=True)
    return ws


def _train(cli, dataset_dir, ws, *extra):
    return cli.main(['train', '--dataset_dir', dataset_dir, '--workspace',
                     ws, *ARGS, '--stop_iteration', '3', '--eval_interval',
                     '2', '--device', 'cpu', *extra])


def _ws(ws, filename='main_strong'):
    return Workspace(root=ws, filename=filename, model_type=MODEL,
                     batch_size=2, augmentation='none')


@pytest.fixture(scope='module')
def strong_run(dataset_dir, packed, tmp_path_factory):
    ws = _copy(packed, tmp_path_factory, 'ws_strong')
    state = _train(main_strong, dataset_dir, ws)
    return ws, state


@pytest.fixture(scope='module')
def weak_run(dataset_dir, packed, tmp_path_factory):
    ws = _copy(packed, tmp_path_factory, 'ws_weak')
    state = _train(main, dataset_dir, ws)
    return ws, state


RUNS = pytest.mark.parametrize('run', ['strong_run', 'weak_run'])


def _lineage(request, run):
    ws, state = request.getfixturevalue(run)
    return ws, state, _ws(ws).checkpoint_path('logmel', '16k')


@RUNS
def test_train_saves_the_lineage_and_keeps_training_mode(request, run):
    """3 iterations, an evaluation at 2: ``iter_2.pth`` + ``BEST``; the
    model is still in training mode after the evaluation; the statistics
    of iteration 2 are dumped."""
    ws, state, lineage = _lineage(request, run)
    assert state.step == 3 and state.model.training
    assert sorted(os.listdir(lineage)) == ['BEST', 'iter_2.pth']
    assert open(os.path.join(lineage, 'BEST')).read() == '2'
    obj = torch.load(os.path.join(lineage, 'iter_2.pth'),
                     weights_only=True)
    assert obj['iteration'] == 2 and set(obj) == {'iteration', 'model',
                                                  'optimizer'}
    assert obj['model']['fc.weight'].shape == (25, 512)
    with open(_ws(ws).statistics_path('logmel', '16k'), 'rb') as f:
        stats = pickle.load(f)
    kinds = ('valid', 'test') if run == 'strong_run' else ('test',)
    for kind in kinds:
        assert [s['iteration'] for s in stats[kind]] == [2]


@RUNS
def test_resume_restores_step_and_optimizer_and_truncates_statistics(
        request, run, dataset_dir, tmp_path):
    """``--resume_iteration 2`` restores the checkpoint at 2 (step and
    AMSGrad state), drops the statistics recorded past 2 (a stale entry
    at 4 is gone from the next dump, at the evaluation of 4, which saves
    ``iter_4.pth`` as the new best: the best scores restart with the
    run, as in sed_tpu), and does not evaluate at 2 again;
    ``--resume_iteration 1`` raises with the saved iterations listed."""
    ws, _, lineage = _lineage(request, run)
    ws2 = str(tmp_path / 'ws')
    shutil.copytree(ws, ws2)
    stats_path = _ws(ws2).statistics_path('logmel', '16k')
    with open(stats_path, 'rb') as f:
        stats = pickle.load(f)
    stats['test'].append({'iteration': 4})
    with open(stats_path, 'wb') as f:
        pickle.dump(stats, f)
    cli = main_strong if run == 'strong_run' else main
    saved = torch.load(os.path.join(lineage, 'iter_2.pth'),
                       weights_only=True)['optimizer']
    state = _train(cli, dataset_dir, ws2, '--resume_iteration', '2',
                   '--stop_iteration', '5')
    assert state.step == 5
    p = next(state.model.parameters())
    assert state.optimizer.state[p]['step'] == 5
    assert saved['state'][0]['step'] == 2
    with open(stats_path, 'rb') as f:
        after = pickle.load(f)
    assert [s['iteration'] for s in after['test']] == [2, 4]
    assert 'clipwise_ap' in after['test'][-1]
    with pytest.raises(FileNotFoundError,
                       match=r'saved iterations: \[2, 4\]'):
        _train(cli, dataset_dir, ws2, '--resume_iteration', '1')


@RUNS
def test_inference_prob_runs_on_the_saved_checkpoint(request, run,
                                                     dataset_dir, capsys):
    """``inference_prob`` finds the lineage's best checkpoint without
    ``--checkpoint`` and evaluates the testing split with it."""
    ws, state, lineage = _lineage(request, run)
    cli = main_strong if run == 'strong_run' else main
    capsys.readouterr()
    stats = cli.main(['inference_prob', '--dataset_dir', dataset_dir,
                      '--workspace', ws, *ARGS, '--device', 'cpu'])
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith('Micro')]
    assert len(lines) == (4 if run == 'strong_run' else 2)
    assert 'sed_metrics' in stats
    pkl = _ws(ws).predictions_path('test_predictions_logmel_16k.pkl')
    with open(pkl, 'rb') as f:
        out = pickle.load(f)
    assert out['framewise_output'].shape == (3, 1000, 25)


def test_saved_pth_loads_into_sed_tpu_flax_variables(strong_run):
    """``sed_tpu.compat.torch_loader`` reads ``iter_2.pth`` (the reference
    layout) into flax variables; sed_tpu's model with them gives the
    port model's framewise and clipwise outputs within 1e-5."""
    from sed_tpu.compat.torch_loader import load_checkpoint_variables
    from sed_tpu.models.registry import get_model as jax_get_model
    from sed_tpu_torch.compat.from_flax import load_checkpoint
    lineage = _ws(strong_run[0]).checkpoint_path('logmel', '16k')
    path = os.path.join(lineage, 'iter_2.pth')
    variables, iteration = load_checkpoint_variables(path)
    assert iteration == 2
    wav = make_clips(2, CFG.sample_rate, seconds=2, seed=5)
    want = jax_get_model(MODEL, CFG).apply(variables, wav, train=False)
    port = load_checkpoint(path, MODEL, CFG, 'cpu')
    with torch.no_grad():
        got = port(torch.from_numpy(wav))
    for key in ('framewise_output', 'clipwise_output'):
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(want[key]), atol=1e-5)


@pytest.fixture(scope='module')
def bf16_run(dataset_dir, packed, tmp_path_factory):
    ws = _copy(packed, tmp_path_factory, 'ws_bf16')
    state = main_strong.main([
        'train', '--dataset_dir', dataset_dir, '--workspace', ws, *ARGS,
        '--stop_iteration', '2', '--eval_interval', '1', '--device', 'cpu',
        '--compute_dtype', 'bf16'])
    return ws, state


def test_train_defaults_to_the_card_and_trains_bf16(dataset_dir, tmp_path,
                                                    bf16_run):
    """``--device`` defaults to ``cuda`` (which raises on a host without
    CUDA); ``--compute_dtype bf16`` trains: the model's ConvBlocks
    compute in bf16 and the loss-scaled step ran (2 steps)."""
    base = ['train', '--dataset_dir', dataset_dir, '--workspace',
            str(tmp_path), *ARGS]
    assert main_strong.get_parser().parse_args(base).device == 'cuda'
    assert main.get_parser().parse_args(base).device == 'cuda'
    assert main_strong.get_parser().parse_args(
        [*base, '--compute_dtype', 'bf16']).compute_dtype == 'bf16'
    _, state = bf16_run
    assert state.step == 2
    assert state.model.compute_dtype is torch.bfloat16
    assert state.model.conv_block1.conv1.compute_dtype is torch.bfloat16
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA')
    for cli in (main_strong, main):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            cli.main(base)


def test_bf16_train_writes_a_float32_pth_both_packages_read(bf16_run):
    """2 bf16 iterations (an evaluation at 1): ``iter_1.pth`` holds float32
    tensors with the fp32 model's keys; the port's ``load_checkpoint`` and
    ``sed_tpu``'s ``.pth`` reader both load it, and their fp32 models give
    the same outputs within 1e-5."""
    from sed_tpu.compat.torch_loader import load_checkpoint_variables
    from sed_tpu.models.registry import get_model as jax_get_model
    from sed_tpu_torch.compat.from_flax import load_checkpoint
    from sed_tpu_torch.models.registry import get_model
    ws, state = bf16_run
    path = os.path.join(_ws(ws).checkpoint_path('logmel', '16k'),
                        'iter_1.pth')
    obj = torch.load(path, weights_only=True)
    fp32 = get_model(MODEL, CFG).state_dict()
    assert obj['model'].keys() == fp32.keys()
    assert all(v.dtype == fp32[k].dtype for k, v in obj['model'].items())
    assert all(v.dtype == torch.float32 for v in obj['model'].values()
               if v.is_floating_point())
    variables, iteration = load_checkpoint_variables(path)
    assert iteration == 1
    wav = make_clips(2, CFG.sample_rate, seconds=2, seed=6)
    want = jax_get_model(MODEL, CFG).apply(variables, wav, train=False)
    port = load_checkpoint(path, MODEL, CFG, 'cpu')
    with torch.no_grad():
        got = port(torch.from_numpy(wav))
    for key in ('framewise_output', 'clipwise_output'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5)


def _args(**kw):
    return argparse.Namespace(**{'checkpoint': None,
                                 'feature_type': 'logmel', **kw})


def test_checkpoint_path_resolves_lineage_flat_pth_and_refuses_orbax(
        tmp_path):
    """The workspace checkpoint: the lineage's ``BEST``, else its highest
    ``iter_<N>.pth``; else the flat reference ``.pth``; a directory with
    Orbax metadata, at the stem or as ``iter_<N>``, exits naming the
    export; nothing at all exits."""
    ws = _ws(str(tmp_path))
    stem = ws.checkpoint_path('logmel', '16k', create=True)
    pth = ws.torch_checkpoint_path('logmel', '16k')
    with pytest.raises(SystemExit, match='random'):
        common.checkpoint_path(_args(), CFG, ws)
    open(pth, 'wb').close()
    assert common.checkpoint_path(_args(), CFG, ws) == pth
    os.makedirs(stem)
    assert common.checkpoint_path(_args(), CFG, ws) == pth
    for n in (3, 7):
        open(os.path.join(stem, f'iter_{n}.pth'), 'wb').close()
    assert common.checkpoint_path(_args(), CFG, ws) == \
        os.path.join(stem, 'iter_7.pth')
    with open(os.path.join(stem, 'BEST'), 'w') as f:
        f.write('3')
    assert common.checkpoint_path(_args(), CFG, ws) == \
        os.path.join(stem, 'iter_3.pth')
    assert common.checkpoint_path(_args(checkpoint='x.npz'), CFG,
                                  ws) == 'x.npz'
    assert ckpt.best_checkpoint_path(stem) == os.path.join(stem,
                                                           'iter_3.pth')
    # sed_tpu's Orbax lineage (iter_<N> directories) and a flat Orbax dir
    shutil.rmtree(stem)
    os.makedirs(os.path.join(stem, 'iter_5'))
    open(os.path.join(stem, 'iter_5', '_CHECKPOINT_METADATA'), 'w').close()
    with open(os.path.join(stem, 'BEST'), 'w') as f:
        f.write('5')
    with pytest.raises(SystemExit, match='save_variables_npz'):
        common.checkpoint_path(_args(), CFG, ws)
    shutil.rmtree(stem)
    os.makedirs(stem)
    open(os.path.join(stem, 'manifest.ocdbt'), 'w').close()
    with pytest.raises(SystemExit, match='save_variables_npz'):
        common.checkpoint_path(_args(), CFG, ws)


def test_train_with_a_compressed_wire_fsd50k_and_all_augmentations(
        dataset_dir, packed, tmp_path_factory):
    """``--train_wire q6`` (decoded on the device by the step),
    ``--fsd50k`` (a second strong stream: the strong_training file
    packed again under the FSD50K split's name) and
    ``specaugment_timeshift_mixup`` (weak batches of 12, strong of 4):
    two steps train, every parameter stays finite and moves."""
    ws = _copy(packed, tmp_path_factory, 'ws_wire')
    hdf5s = os.path.join(ws, 'hdf5s')
    shutil.copy(os.path.join(hdf5s, 'strong_training_logmel_16k.h5'),
                os.path.join(hdf5s, 'strong_fsd50k_logmel_16k.h5'))
    from sed_tpu_torch.models.registry import get_model
    from sed_tpu_torch.models.blocks import init_weights
    fresh = init_weights(get_model(MODEL, CFG),
                         torch.Generator().manual_seed(0)).state_dict()
    state = main_strong.main([
        'train', '--dataset_dir', dataset_dir, '--workspace', ws, *ARGS,
        '--augmentation', 'specaugment_timeshift_mixup', '--train_wire',
        'q6', '--fsd50k', '--stop_iteration', '2', '--device', 'cpu'])
    assert state.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.isfinite(v.float()).all(), k
        if k.endswith('conv1.weight'):
            assert not torch.equal(v, fresh[k]), k


def test_train_a_token_pooling_conformer_with_the_logits_losses(
        dataset_dir, packed, tmp_path_factory):
    """``main_strong train --model_type Cnn_7layers_Conformer --loss_type
    clip_bce_logits``: the model's outputs are logits, so the strong loss
    is ``frame_bce_logits`` too (``frame_bce`` of a logit is NaN).  Three
    iterations with an evaluation at 2: finite parameters that moved, and
    ``iter_2.pth`` in the reference's layout (``cnn.cnn.*``,
    ``encoder.conformer_blocks.*``), which ``inference_prob`` finds and
    loads by itself."""
    name = 'Cnn_7layers_Conformer'
    ws = _copy(packed, tmp_path_factory, 'ws_token')
    base = ['--dataset_dir', dataset_dir, '--workspace', ws, *ARGS[2:],
            '--model_type', name, '--loss_type', 'clip_bce_logits',
            '--device', 'cpu']
    from sed_tpu_torch.models.blocks import init_weights
    from sed_tpu_torch.models.registry import get_model
    fresh = init_weights(get_model(name, CFG),
                         torch.Generator().manual_seed(0)).state_dict()
    state = main_strong.main(['train', *base, '--stop_iteration', '3',
                              '--eval_interval', '2'])
    assert state.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.isfinite(v.float()).all(), k
    assert not torch.equal(state.model.classifier.weight, fresh[
        'classifier.weight'])
    lineage = Workspace(root=ws, model_type=name, loss_type='clip_bce_logits',
                        batch_size=2, augmentation='none').checkpoint_path(
                            'logmel', '16k')
    saved = torch.load(os.path.join(lineage, 'iter_2.pth'),
                       weights_only=True)['model']
    assert saved['cnn.cnn.conv0.weight'].shape == (16, 1, 3, 3)
    assert saved['encoder.conformer_blocks.0.conv.conv.1.conv.weight'
                 ].shape == (288, 144, 1)
    stats = main_strong.main(['inference_prob', *base])
    assert stats['framewise_ap'].shape == (25,)
