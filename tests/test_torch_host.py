"""sed_tpu_torch's own host modules against the ``sed_tpu`` functions they
were copied from, and the port's independence from the JAX package.

The copies are numpy code kept verbatim, so every comparison here is
exact: equal arrays (``np.array_equal``), identical event lists, XML
strings and metric dicts.
"""

import csv
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from sed_tpu import config as jax_config
from sed_tpu.cli import common as jax_cli_common
from sed_tpu.dsp import filters as jax_filters
from sed_tpu.eval import ap as jax_ap
from sed_tpu.eval import calculate_metrics as jax_calc
from sed_tpu.eval import segment_metrics as jax_segment_metrics
from sed_tpu.native import vad_native as jax_vad_native
from sed_tpu.post import events as jax_events
from sed_tpu.post import merge as jax_merge
from sed_tpu.post import xml_writer as jax_xml_writer
from sed_tpu.utils.paths import Workspace as JaxWorkspace
from sed_tpu_torch import bench_corpus, config
from sed_tpu_torch.cli import common as cli_common
from sed_tpu_torch.data import audio_io
from sed_tpu_torch.dsp import filters
from sed_tpu_torch.eval import ap, calculate_metrics, segment_metrics
from sed_tpu_torch.native import vad_native
from sed_tpu_torch.post import events, merge, xml_writer
from sed_tpu_torch.utils.paths import Workspace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import bench_corpus as tools_bench_corpus  # noqa: E402

CFGS = pytest.mark.parametrize('quality', ['8k', '16k', '32k'])


def _framewise(seed: int, n: int = 3, frames: int = 500) -> np.ndarray:
    """Smooth seeded probabilities with runs above and below the
    thresholds (a random walk through a sigmoid)."""
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.standard_normal((n, frames, 25)) * 0.4, axis=1)
    return (1.0 / (1.0 + np.exp(-walk + 1.0))).astype(np.float32)


def test_config_equals_sed_tpu():
    assert config.LABELS == jax_config.LABELS
    assert config.IDS == jax_config.IDS
    for q in ('8k', '16k', '32k'):
        assert dataclasses.asdict(config.QUALITY[q]) == \
            dataclasses.asdict(jax_config.QUALITY[q])
    for name in ('EVAL_SED_PARAMS', 'PREDICT_SED_PARAMS'):
        assert getattr(config, name).per_class() == \
            getattr(jax_config, name).per_class()


@CFGS
def test_frontend_arrays_equal_sed_tpu(quality):
    got = filters.frontend_arrays(config.QUALITY[quality])
    want = jax_filters.frontend_arrays(jax_config.QUALITY[quality])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.flags.f_contiguous == \
            w.flags.f_contiguous
        assert np.array_equal(g, w)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_event_decoding_equals_sed_tpu(seed):
    fw = _framewise(seed)
    for params in (config.PREDICT_SED_PARAMS, config.EVAL_SED_PARAMS):
        jparams = jax_config.SedParams(**dataclasses.asdict(params))
        for i in range(fw.shape[0]):
            got = events.frame_prediction_to_event_prediction_v2(
                fw[i:i + 1], f'c{i}.wav', params, 100, config.LABELS)
            want = jax_events.frame_prediction_to_event_prediction_v2(
                fw[i:i + 1], f'c{i}.wav', jparams, 100, jax_config.LABELS)
            assert got == want
        names = np.array([f'c{i}.wav' for i in range(fw.shape[0])])
        out = {'audio_name': names, 'framewise_output': fw}
        assert events.frame_prediction_to_event_prediction(
            out, params, 100) == \
            jax_events.frame_prediction_to_event_prediction(
                out, jparams, 100)


@pytest.mark.parametrize('step,window', [(0.5, 6), (1, 5), (1, 7)])
def test_merging_equals_sed_tpu(step, window):
    interval = int(100 * step)
    w_count = 9 if step == 0.5 else 5
    t_win = window * 100
    total = t_win + (w_count - 1) * interval
    assert np.array_equal(merge.coverage_counts(total, window, step),
                          jax_merge.coverage_counts(total, window, step))
    wins = _framewise(7, n=w_count, frames=t_win)
    for normalize in (True, False):
        assert np.array_equal(
            merge.overlap_add_windows(wins, window, step, normalize),
            jax_merge.overlap_add_windows(wins, window, step, normalize))


def test_events_to_xml_equals_sed_tpu():
    evs = events.frame_prediction_to_event_prediction_v2(
        _framewise(3, n=1), 'a&b.wav', config.PREDICT_SED_PARAMS, 100,
        config.LABELS)
    assert evs
    for fallback in (None, (0, 5)):
        assert xml_writer.events_to_xml(evs, 'a&b.wav', fallback) == \
            jax_xml_writer.events_to_xml(evs, 'a&b.wav', fallback)
    assert xml_writer.events_to_xml([], 'x.wav', (1.0, 3.5)) == \
        jax_xml_writer.events_to_xml([], 'x.wav', (1.0, 3.5))


def test_official_evaluate_equals_sed_tpu(tmp_path):
    clips, truth = bench_corpus.make_clips(6, 16000, seconds=10, seed=4,
                                           return_events=True)
    del clips
    ref = tmp_path / 'ref.csv'
    with open(ref, 'w', newline='') as f:
        w = csv.writer(f)
        for i, evs in enumerate(truth):
            for e in evs:
                w.writerow([f'c{i}.wav', e['onset'], e['offset'],
                            e['event_label']])
    fw = _framewise(5, n=6, frames=1000)
    out = {'audio_name': np.array([f'c{i}.wav' for i in range(6)]),
           'framewise_output': fw}
    sub = str(tmp_path / 'sub.tsv')
    events.write_submission(events.frame_prediction_to_event_prediction(
        out, config.EVAL_SED_PARAMS, 100), sub)
    got = segment_metrics.official_evaluate(str(ref), sub)
    assert got == jax_segment_metrics.official_evaluate(str(ref), sub)
    assert got['overall']['f_measure']['f_measure'] >= 0


def test_native_decoder_pairs_equal_sed_tpu():
    assert vad_native.native_available() == \
        jax_vad_native.native_available()
    if not vad_native.native_available():
        pytest.skip('no g++ on this host')
    rng = np.random.RandomState(11)
    x = _framewise(11, n=40, frames=500).transpose(0, 2, 1).reshape(-1, 500)
    high = np.packbits(x > 0.5, axis=1)
    low = np.packbits(x >= rng.uniform(0.1, 0.4, (x.shape[0], 1)), axis=1)
    n_smooth = rng.randint(0, 12, x.shape[0]).astype(np.int32)
    n_salt = rng.randint(0, 12, x.shape[0]).astype(np.int32)
    for lo in (low, None):
        got = vad_native.decode_packed_tracks(high, lo, 500, n_smooth,
                                              n_salt)
        assert got == jax_vad_native.decode_packed_tracks(
            high, lo, 500, n_smooth, n_salt)
        assert sum(map(len, got)) > 0
    # the port builds its library under build/, not beside its source
    assert vad_native._lib_path().startswith(
        os.path.join(REPO, 'build', 'sed_tpu_torch'))


def test_metrics_equal_sed_tpu():
    rng = np.random.RandomState(2)
    target = (rng.rand(20, 25) < 0.3).astype(np.float32)
    target[0] = 1
    out = rng.rand(20, 25).astype(np.float32)
    assert np.array_equal(
        ap.clipwise_average_precision(target, out),
        jax_ap.clipwise_average_precision(target, out))
    strong = (rng.rand(4, 30, 25) < 0.3).astype(np.float32)
    fw = rng.rand(4, 30, 25).astype(np.float32)
    assert np.array_equal(ap.sed_average_precision(strong, fw),
                          jax_ap.sed_average_precision(strong, fw))
    thr = rng.uniform(0.2, 0.8, 25)
    assert calculate_metrics.calculate_precision_recall_f1(
        strong, fw, thr) == jax_calc.calculate_precision_recall_f1(
            strong, fw, thr)


def test_workspace_and_cli_flags_equal_sed_tpu(tmp_path):
    import argparse
    argv = ['--dataset_dir', 'DS', '--workspace', str(tmp_path),
            '--audio_16k', '--batch_size', '8', '--mini_data']
    parsers = []
    for add in (cli_common.add_common_args,
                jax_cli_common.add_common_args):
        p = argparse.ArgumentParser()
        add(p)
        parsers.append(p.parse_args(argv))
    args, jargs = parsers
    assert vars(args) == vars(jargs)
    cfg, ws = cli_common.resolve(args)
    jcfg, jws = jax_cli_common.resolve(jargs)
    assert cfg.name == jcfg.name == '16k'
    assert dataclasses.asdict(ws) == dataclasses.asdict(jws)
    assert isinstance(ws, Workspace) and isinstance(jws, JaxWorkspace)
    for kind in ('checkpoints', 'predictions', 'statistics'):
        assert ws.dir(kind) == jws.dir(kind)
    assert ws.torch_checkpoint_path('logmel', '16k') == \
        jws.torch_checkpoint_path('logmel', '16k')
    assert cli_common.hdf5_path(args, cfg, 'testing') == \
        jax_cli_common.hdf5_path(jargs, jcfg, 'testing')
    assert cli_common.reference_csv_paths(args) == \
        jax_cli_common.reference_csv_paths(jargs)


@pytest.mark.parametrize('seed', [0, 5, 21])
def test_bench_corpus_equals_tools_copy(seed):
    got, got_ev = bench_corpus.make_clips(5, 16000, seconds=5, seed=seed,
                                          return_events=True)
    want, want_ev = tools_bench_corpus.make_clips(
        5, 16000, seconds=5, seed=seed, return_events=True)
    assert np.array_equal(got, want)
    assert got_ev == want_ev
    assert bench_corpus.CLASS_LABELS == tools_bench_corpus.CLASS_LABELS


def test_audio_io_round_trip_equals_sed_tpu(tmp_path):
    from sed_tpu.data import audio_io as jax_audio_io
    x = bench_corpus.make_clips(1, 16000, seconds=3, seed=2)[0]
    path = str(tmp_path / 'x.wav')
    audio_io.save_wav(path, x, 16000)
    for sr in (None, 8000, 16000, 32000):
        got = audio_io.load_audio(path, sr=sr)
        want = jax_audio_io.load_audio(path, sr=sr)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
    rows = [x[:100], x[100:200]]
    assert np.array_equal(audio_io.stack_rows(rows),
                          jax_audio_io.stack_rows(rows))
    assert np.array_equal(audio_io.pad_truncate(x[:10], 16),
                          jax_audio_io.pad_truncate(x[:10], 16))


_BLOCKED = ('sed_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax')

_GUARD_SCRIPT = r'''
import importlib, importlib.abc, pkgutil, runpy, sys

BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)

sys.meta_path.insert(0, Block())
import sed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sed_tpu_torch.__path__,
                                               'sed_tpu_torch.')]
for name in names:
    importlib.import_module(name)
for cli in ('predict', 'main_strong', 'optimize_thresholds', 'main'):
    sys.argv = [cli, '--help']
    try:
        runpy.run_module('sed_tpu_torch.cli.' + cli, run_name='__main__')
    except SystemExit as e:
        assert e.code in (0, None), (cli, e.code)
    else:
        raise AssertionError(cli + ' --help did not exit')
bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not bad, bad
print('MODULES', len(names))
''' % (_BLOCKED,)


def test_port_imports_nothing_of_the_jax_package():
    """Every module of sed_tpu_torch imports (the training modules
    included), and the four CLIs answer --help, in a process where
    sed_tpu, jax, jaxlib, flax, optax and orbax cannot be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _GUARD_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'usage:' in proc.stdout
    n = int(proc.stdout.split('MODULES')[1].split()[0])
    assert n >= 44, proc.stdout[-500:]
    for name in ('augment.functional', 'losses', 'train.state', 'train.step',
                 'train.checkpoint', 'train.prefetch', 'utils.statistics',
                 'utils.logging_utils', 'cli.main', 'models.encoders',
                 'models.conformer_zoo', 'models.vggish', 'models.panns'):
        assert os.path.isfile(os.path.join(
            REPO, 'sed_tpu_torch', *name.split('.')) + '.py'), name
    assert not os.path.exists(os.path.join(REPO, 'sed_tpu_torch',
                                           '_host.py'))


def test_entry_points_default_to_the_card(tmp_path):
    """Without a device the engine, the evaluator and the CLIs ask for
    ``cuda``; on a host without CUDA that raises, it never falls back to
    the CPU."""
    import torch
    from sed_tpu_torch.cli import main_strong, optimize_thresholds, predict
    from sed_tpu_torch.compat.from_flax import load_npz
    from sed_tpu_torch.eval.evaluator import Evaluator
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    base = ['--workspace', str(tmp_path), '--dataset_dir', str(tmp_path)]
    assert predict.get_parser().parse_args(
        ['predict', *base, '--input_dir', str(tmp_path)]).device == 'cuda'
    assert main_strong.get_parser().parse_args(
        ['inference_prob', *base]).device == 'cuda'
    assert optimize_thresholds.get_parser().parse_args(
        ['optimize_sed_thresholds', *base]).device == 'cuda'
    if torch.cuda.is_available():
        pytest.skip('this host has CUDA')
    model = load_npz(os.path.join(REPO, 'tools', 'bench_checkpoint.npz'),
                     'Cnn_9layers_Gru_FrameAtt', config.AUDIO_16K, 'cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        SedInferenceEngine(model, config.AUDIO_16K)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Evaluator(model)


# ---------------------------------------------------------------------------
# the training path's host copies
# ---------------------------------------------------------------------------


def test_mixup_generator_stream_equals_sed_tpu():
    from sed_tpu.augment.functional import MixupGenerator as JaxMixup
    from sed_tpu_torch.augment.functional import MixupGenerator
    a, b = MixupGenerator(1.0), JaxMixup(1.0)
    for n in (192, 64, 64, 6, 2):
        assert np.array_equal(a.get_lambda(n), b.get_lambda(n))


def _h5(path, n, samples=16000, seed=0):
    import h5py
    rng = np.random.RandomState(seed)
    with h5py.File(path, 'w') as hf:
        hf.create_dataset('audio_name', data=np.array(
            [f'c{i}.wav'.encode() for i in range(n)], dtype='S20'))
        hf.create_dataset('waveform', data=(rng.uniform(-0.5, 0.5, (
            n, samples)) * 32767).astype(np.int16))
        hf.create_dataset('target', data=(rng.rand(n, 25) > 0.7)
                          .astype(np.float32))
        hf.create_dataset('strong_target', data=(rng.rand(n, 16, 25) > 0.8)
                          .astype(np.float32))
    return str(path)


@pytest.mark.parametrize('n,batch', [(7, 3), (5, 5), (4, 6)])
def test_train_sampler_stream_equals_sed_tpu(tmp_path, n, batch):
    """The reference's self-composed permutation stream, reshuffles
    mid-batch included, for 12 batches."""
    from sed_tpu.data.dataset import TrainSampler as JaxTrainSampler
    from sed_tpu_torch.data.dataset import TrainSampler, cycle_iteration
    path = _h5(tmp_path / 'x.h5', n)
    got, want = iter(TrainSampler(path, batch)), iter(
        JaxTrainSampler(path, batch))
    for _ in range(12):
        assert next(got) == next(want)
    loader = cycle_iteration([1, 2])
    assert [next(loader) for _ in range(5)] == [1, 2, 1, 2, 1]


@pytest.mark.parametrize('wire', ['int16', 'mulaw8', 'q6', 'adpcm4', None])
@pytest.mark.parametrize('workers', [1, 3])
def test_training_loader_batches_equal_sed_tpu(tmp_path, wire, workers):
    """``AudiosetDataset(dequantize=False, wire=...)`` rows through the
    worker-pool loader: the same batches, in the same order, bit for bit
    (sed_tpu's adpcm4 encoder is native where it builds; the port's copy
    is its numpy oracle)."""
    from sed_tpu.data.dataset import (AudiosetDataset as JaxDataset,
                                      DataLoader as JaxLoader,
                                      TrainSampler as JaxTrainSampler)
    from sed_tpu_torch.data.dataset import (AudiosetDataset, DataLoader,
                                            TrainSampler)
    path = _h5(tmp_path / 'x.h5', 6)
    kw = {} if wire is None else dict(dequantize=False, wire=wire)
    got = iter(DataLoader(AudiosetDataset(**kw), TrainSampler(path, 4),
                          num_workers=workers))
    want = iter(JaxLoader(JaxDataset(**kw), JaxTrainSampler(path, 4),
                          num_workers=workers))
    for _ in range(4):
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_statistics_container_equals_sed_tpu(tmp_path):
    """Append, dump and the truncating resume give sed_tpu's pickles."""
    from sed_tpu.utils.statistics import StatisticsContainer as JaxStats
    from sed_tpu_torch.utils.statistics import StatisticsContainer
    dumps = []
    for cls, name in ((StatisticsContainer, 'port'), (JaxStats, 'jax')):
        path = str(tmp_path / name / 'statistics.pkl')
        c = cls(path)
        for it in (0, 2, 4):
            c.append('valid', it, {'clipwise_ap': np.arange(3.0) * it})
            c.append('test', it, {'er': it / 10})
        c.dump()
        c.load_state_dict(2)
        dumps.append((open(path, 'rb').read(), c.statistics_dict))
    assert dumps[0][0] == dumps[1][0]
    got, want = dumps[0][1], dumps[1][1]
    assert got.keys() == want.keys()
    for k in got:
        assert [s['iteration'] for s in got[k]] == \
            [s['iteration'] for s in want[k]]
    assert [s['iteration'] for s in got['valid']] == [0, 2]


def test_logging_and_workspace_copies_equal_sed_tpu(tmp_path):
    """``create_logging``'s numbered files and ``count_parameters``'s
    table total (the port's over an nn.Module, sed_tpu's over the flax
    tree of the same model); the statistics and logs paths."""
    import logging
    import jax
    from sed_tpu.models.registry import get_model as jax_get_model
    from sed_tpu.utils import logging_utils as jax_logging
    from sed_tpu_torch.models.registry import get_model
    from sed_tpu_torch.utils import logging_utils
    for mod, name in ((logging_utils, 'port'), (jax_logging, 'jax')):
        d = str(tmp_path / name)
        mod.create_logging(d)
        mod.create_logging(d)
        assert sorted(os.listdir(d)) == ['0000.log', '0001.log']
    logging.getLogger('').handlers.clear()
    cfg = config.AUDIO_16K
    narrow = dict(conv_channels=(8, 16, 16, 32), gru_hidden=16)
    jm = jax_get_model('Cnn_9layers_Gru_FrameAtt', cfg, **narrow)
    variables = jax.jit(lambda k: jm.init(
        {'params': k}, np.zeros((1, 16000), np.float32)))(
            jax.random.PRNGKey(0))
    assert logging_utils.count_parameters(get_model(
        'Cnn_9layers_Gru_FrameAtt', cfg, **narrow)) == \
        jax_logging.count_parameters(variables['params'])
    ws, jws = Workspace(root='r'), JaxWorkspace(root='r')
    assert ws.statistics_path('logmel', '16k') == \
        jws.statistics_path('logmel', '16k')
    assert ws.logs_dir() == jws.logs_dir()
