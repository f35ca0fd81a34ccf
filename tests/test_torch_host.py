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
    assert config.SPEECH_LABELS == jax_config.SPEECH_LABELS
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
for cli in ('cli.predict', 'cli.main_strong', 'cli.optimize_thresholds',
            'cli.main', 'cli.features', 'cli.calculate_metrics',
            'cli.download', 'dsp.plot', 'parallel.dryrun'):
    sys.argv = [cli, '--help']
    try:
        runpy.run_module('sed_tpu_torch.' + cli, run_name='__main__')
    except SystemExit as e:
        assert e.code in (0, None), (cli, e.code)
    else:
        raise AssertionError(cli + ' --help did not exit')
sys.argv = ['cli.predict', 'predict_asr', '--help']
try:
    runpy.run_module('sed_tpu_torch.cli.predict', run_name='__main__')
except SystemExit as e:
    assert e.code in (0, None), ('predict_asr', e.code)
bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not bad, bad
print('MODULES', len(names))
''' % (_BLOCKED,)


def test_port_imports_nothing_of_the_jax_package():
    """Every module of sed_tpu_torch imports (the training modules
    included), and the seven CLIs, ``predict predict_asr``, the plot CLI
    and the multi-device dry run answer --help, in a process where
    sed_tpu, jax, jaxlib, flax, optax and orbax cannot be imported."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _GUARD_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'usage:' in proc.stdout and '--asr_language' in proc.stdout
    n = int(proc.stdout.split('MODULES')[1].split()[0])
    assert n >= 78, proc.stdout[-500:]
    for name in ('augment.functional', 'losses', 'train.state', 'train.step',
                 'train.checkpoint', 'train.prefetch', 'utils.statistics',
                 'utils.logging_utils', 'cli.main', 'models.encoders',
                 'models.conformer_zoo', 'models.vggish', 'models.panns',
                 'data.metadata', 'data.hdf5_pack', 'data.download',
                 'cli.features', 'cli.download', 'cli.calculate_metrics',
                 'dsp.gammatone', 'dsp.plot', 'dsp.cqt', 'dsp.transforms',
                 'parallel.__init__', 'parallel.distributed', 'parallel.mesh',
                 'parallel.dryrun', 'native.adpcm_native', 'native._gxx',
                 'utils.profiling'):
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


# ---------------------------------------------------------------------------
# data preparation and the gammatone / CQT numpy
# ---------------------------------------------------------------------------

def test_metadata_readers_and_targets_equal_sed_tpu(tmp_path):
    """Weak csv readers of every data_type, the strong reader and both
    targets: sed_tpu's, equal."""
    from sed_tpu.data import metadata as jax_metadata
    from sed_tpu_torch.data import metadata
    labels = config.LABELS
    comma = tmp_path / 'weak.csv'
    comma.write_text(f'abc,3.000,13.000,"{labels[0]},{labels[4]}",/m/x\n'
                     f'def,0.500,10.500,"{labels[2]}",/m/y\n')
    tab = tmp_path / 'eval.tsv'
    tab.write_text(f'a.wav\t0.1\t1.0\t{labels[1]}\n'
                   f'a.wav\t2.0\t3.0\t{labels[3]}\nb.wav\t0\t1\t{labels[1]}\n')
    strong = tmp_path / 'strong.csv'
    strong.write_text(f'abc_3.wav,0.25,1.755,{labels[0]}\n'
                      f'abc_3.wav,5,9.995,{labels[4]}\n'
                      f'def_0.wav,0,10,{labels[2]}\n')
    for data_type in ('training', 'testing', 'weak_training',
                      'strong_training', 'strong_validation',
                      'strong_fsd50k', 'evaluation'):
        assert metadata.get_weak_csv_filename(data_type) == \
            jax_metadata.get_weak_csv_filename(data_type)
        path = tab if data_type == 'evaluation' else comma
        got = metadata.read_weak_csv(str(path), data_type)
        assert got == jax_metadata.read_weak_csv(str(path), data_type)
    with pytest.raises(ValueError):
        metadata.get_weak_csv_filename('nope')
    meta = metadata.read_strong_csv(str(strong))
    assert meta == jax_metadata.read_strong_csv(str(strong))
    for name in ('abc_3.wav', 'def_0.wav', 'none.wav'):
        for fps in (100, 50):
            assert np.array_equal(
                metadata.get_strong_target(name, meta, 1000, fps),
                jax_metadata.get_strong_target(name, meta, 1000, fps))
    for row in metadata.read_weak_csv(str(comma), 'training'):
        got = metadata.get_weak_target(row['labels'])
        assert got.dtype == bool and np.array_equal(
            got, jax_metadata.get_weak_target(row['labels']))


def test_hdf5_pack_helpers_equal_sed_tpu():
    """``float32_to_int16`` (peak-normalised only when clipping),
    ``int16_to_float32`` and ``hdf5_filename``."""
    from sed_tpu.data import hdf5_pack as jax_pack
    from sed_tpu_torch.data import hdf5_pack
    rng = np.random.RandomState(1)
    for x in (rng.uniform(-0.9, 0.9, 1000), rng.uniform(-1.7, 1.3, 1000),
              np.zeros(10), np.float32([1.0, -1.0, 0.5])):
        got = hdf5_pack.float32_to_int16(x)
        assert got.dtype == np.int16
        assert np.array_equal(got, jax_pack.float32_to_int16(x))
        assert np.array_equal(hdf5_pack.int16_to_float32(got),
                              jax_pack.int16_to_float32(got))
    for args in (('testing', 'gamma', '8k'), ('weak_training', 'logmel',
                                              '16k', True)):
        assert hdf5_pack.hdf5_filename(*args) == \
            jax_pack.hdf5_filename(*args)
    assert hdf5_pack.hdf5_filename('testing', 'gamma', '32k', True) == \
        'minidata_testing_gamma_32k.h5'


@CFGS
def test_gammatone_numpy_equals_sed_tpu(quality):
    """Every numpy function of ``dsp/gammatone.py`` bit for bit at the
    quality's geometry: the ERB scale, the filter design, the FFT weights
    and window, the cached analysis matrices, ``fft_gtgram`` at a length
    whose last frame ends on the clip (the trailing all-zero column) and
    at one that does not, ``power_to_db_np``, ``gtgram_frames`` and the
    packed ``fft_gtgram_db`` of a 10 s clip."""
    from sed_tpu.dsp import gammatone as jgt
    from sed_tpu_torch.dsp import gammatone as gt
    cfg = config.QUALITY[quality]
    fs, ch, fmin = cfg.sample_rate, cfg.mel_bins, cfg.fmin
    wt, ht = cfg.window_size / fs, cfg.hop_size / fs
    assert (gt.EAR_Q, gt.MIN_BW) == (jgt.EAR_Q, jgt.MIN_BW)
    frac = np.linspace(0, 1, 7)
    assert np.array_equal(gt.erb_point(fmin, fs / 2, frac),
                          jgt.erb_point(fmin, fs / 2, frac))
    assert np.array_equal(gt.erb_space(fmin, fs / 2, ch),
                          jgt.erb_space(fmin, fs / 2, ch))
    cfs = gt.centre_freqs(fs, ch, fmin)
    assert np.array_equal(cfs, jgt.centre_freqs(fs, ch, fmin))
    for width in (1.0, 0.5):
        assert np.array_equal(gt.make_erb_filters(fs, cfs, width),
                              jgt.make_erb_filters(fs, cfs, width))
    x = np.array([-2.5, -0.5, 0.5, 1.49, 2.5])
    assert np.array_equal(gt._round_half_away(x), jgt._round_half_away(x))
    assert gt.gtgram_strides(fs, wt, ht, 4000) == \
        jgt.gtgram_strides(fs, wt, ht, 4000)
    geometry = gt._fft_gtgram_geometry(fs, wt, ht)
    assert geometry == jgt._fft_gtgram_geometry(fs, wt, ht)
    nfft, nwin, nhop = geometry
    assert np.array_equal(gt.specgram_window(nfft, nwin),
                          jgt.specgram_window(nfft, nwin))
    for a, b in zip(gt.fft_weights(nfft, fs, ch, 1, fmin, fs / 2,
                                   nfft / 2 + 1),
                    jgt.fft_weights(nfft, fs, ch, 1, fmin, fs / 2,
                                    nfft / 2 + 1)):
        assert np.array_equal(a, b)
    for a, b in zip(gt._fft_gtgram_matrices(fs, wt, ht, ch, fmin),
                    jgt._fft_gtgram_matrices(fs, wt, ht, ch, fmin)):
        assert np.array_equal(a, b)
    clip = bench_corpus.make_clips(1, fs, seconds=10, seed=3)[0] \
        .astype(np.float64)
    for samples in (nfft + 40 * nhop, nfft + 40 * nhop + 7):
        got = gt.fft_gtgram(clip[:samples], fs, wt, ht, ch, fmin)
        assert np.array_equal(got, jgt.fft_gtgram(clip[:samples], fs, wt,
                                                  ht, ch, fmin))
        assert got.shape == (ch, 41)
        assert (got[:, -1] == 0).all() == (samples == nfft + 40 * nhop)
        assert np.array_equal(gt.power_to_db_np(got),
                              jgt.power_to_db_np(got))
        assert np.array_equal(gt.power_to_db_np(got, top_db=None),
                              jgt.power_to_db_np(got, top_db=None))
    assert gt.gtgram_frames(cfg, cfg.audio_samples) == \
        jgt.gtgram_frames(cfg, cfg.audio_samples) == 994
    packed = gt.fft_gtgram_db(clip, cfg)
    assert packed.shape == (ch, 994)
    assert np.array_equal(packed, jgt.fft_gtgram_db(clip, cfg))


def test_time_domain_gtgram_equals_sed_tpu():
    """``erb_filterbank`` (scipy ``lfilter``) and ``gtgram`` on a short
    clip, bit for bit."""
    from sed_tpu.dsp import gammatone as jgt
    from sed_tpu_torch.dsp import gammatone as gt
    fs = 8000
    clip = bench_corpus.make_clips(1, fs, seconds=1, seed=6)[0] \
        .astype(np.float64)[:4000]
    coefs = gt.make_erb_filters(fs, gt.centre_freqs(fs, 16, 50.0))
    assert np.array_equal(gt.erb_filterbank(clip, coefs),
                          jgt.erb_filterbank(clip, coefs))
    got = gt.gtgram(clip, fs, 0.04, 0.02, 16, 50.0)
    assert got.shape == (16, 24)
    assert np.array_equal(got, jgt.gtgram(clip, fs, 0.04, 0.02, 16, 50.0))


def test_cqt_filterbank_equals_sed_tpu():
    from sed_tpu.dsp import cqt as jax_cqt
    from sed_tpu_torch.dsp import cqt
    for q in ('8k', '16k', '32k'):
        cfg = config.QUALITY[q]
        for kw in (dict(), dict(n_bins=48, fmin=100.0, bins_per_octave=24)):
            got = cqt.cqt_filterbank(cfg.sample_rate, cfg.window_size, **kw)
            assert np.array_equal(got, jax_cqt.cqt_filterbank(
                cfg.sample_rate, cfg.window_size, **kw))
    assert np.array_equal(cqt.cqt_frequencies(24, 55.0, 12),
                          jax_cqt.cqt_frequencies(24, 55.0, 12))


def _download_calls(module, tmp_path, monkeypatch):
    """Run ``module.download_audioset`` on a csv with a good clip, a clip
    whose resolver fails, one whose resolver prints nothing, one whose
    ffmpeg fails and one already on disk, with stubbed tools: (the
    command lists issued, the counts, the files made)."""
    import subprocess
    import types
    tmp_path.mkdir()
    csv_path = tmp_path / 'segments.csv'
    csv_path.write_text('# header\n'
                        'goodclip1,3.000,13.000,"Speech",/m/x\n'
                        'badclip00,0.000,10.000,"Siren",/m/y\n'
                        'emptyurl0,1.500,11.500,"Siren",/m/y\n'
                        'badffmpeg,2.000,12.000,"Siren",/m/y\n'
                        'goodclip2,7.000,17.000,"Train",/m/z\n')
    out_dir = tmp_path / 'wavs'
    out_dir.mkdir()
    (out_dir / 'goodclip2_7.wav').write_bytes(b'RIFF')
    monkeypatch.setattr(module.shutil, 'which',
                        lambda t: None if t == 'yt-dlp' else f'/usr/bin/{t}')
    calls = []

    def fake_run(argv, **kw):
        calls.append(list(argv))
        if argv[0] == 'youtube-dl':
            ytid = argv[-1].split('v=')[1]
            if ytid == 'badclip00':
                raise subprocess.CalledProcessError(1, argv)
            url = '' if ytid == 'emptyurl0' else f'https://cdn/{ytid}.m4a\n'
            return types.SimpleNamespace(stdout=url, returncode=0)
        if 'badffmpeg' in argv[-1]:
            raise OSError('ffmpeg failed')
        open(argv[-1], 'wb').write(b'RIFF')
        return types.SimpleNamespace(returncode=0)

    monkeypatch.setattr(module.subprocess, 'run', fake_run)
    counts = module.download_audioset(str(csv_path), str(out_dir),
                                      sample_rate=8000, duration=5.0)
    calls = [[a.replace(str(tmp_path), '') for a in c] for c in calls]
    return calls, counts, sorted(os.listdir(out_dir))


def test_downloader_issues_sed_tpus_commands(tmp_path, monkeypatch):
    """The stubbed downloader (youtube-dl as the resolver, as when yt-dlp
    is absent) issues sed_tpu's command lists in sed_tpu's order, counts
    the same clips and skips the one on disk; without the tools both
    raise the same RuntimeError.  Nothing is fetched."""
    from sed_tpu.data import download as jax_download
    from sed_tpu_torch.data import download
    got = _download_calls(download, tmp_path / 'port', monkeypatch)
    want = _download_calls(jax_download, tmp_path / 'jax', monkeypatch)
    assert got == want
    calls, counts, files = got
    assert counts == {'downloaded': 1, 'failed': 3}
    assert files == ['goodclip1_3.wav', 'goodclip2_7.wav']
    assert calls[1] == ['ffmpeg', '-y', '-ss', '3.0', '-i',
                        'https://cdn/goodclip1.m4a', '-t', '5.0', '-ar',
                        '8000', '-ac', '1', '/wavs/goodclip1_3.wav']
    for module in (download, jax_download):
        monkeypatch.setattr(module.shutil, 'which', lambda t: None)
        with pytest.raises(RuntimeError, match='yt-dlp/youtube-dl and '
                                               'ffmpeg on PATH'):
            module.download_audioset(str(tmp_path / 'port' /
                                         'segments.csv'), str(tmp_path))


def test_download_cli_paths_equal_sed_tpu(tmp_path, monkeypatch):
    """The download CLI reads ``<workspace>/metadata/{data_type}_set.csv``
    and writes to ``<workspace>/dataset/<data_type>``, as sed_tpu's."""
    from sed_tpu.cli import download as jax_cli
    from sed_tpu_torch.cli import download as cli
    seen = []
    for module in (cli, jax_cli):
        monkeypatch.setattr(
            module, 'download_audioset',
            lambda c, o: seen.append((c, o)) or {'downloaded': 0,
                                                 'failed': 0})
        assert module.main(['--workspace', str(tmp_path), '--data_type',
                            'testing']) == 0
    assert seen[0] == seen[1] == (
        str(tmp_path / 'metadata' / 'testing_set.csv'),
        str(tmp_path / 'dataset' / 'testing'))


def test_calculate_metrics_cli_equals_sed_tpu(tmp_path, capsys):
    """``calculate_metrics`` on a small predictions pickle (with targets)
    and its reference csv: the port's CLI prints and returns sed_tpu's
    clipwise and segment-based metrics."""
    import pickle
    from sed_tpu.cli import calculate_metrics as jax_cli
    from sed_tpu_torch.cli import calculate_metrics as cli
    rng = np.random.RandomState(4)
    names = [f'c{i}_0.wav' for i in range(3)]
    out = {'audio_name': np.array(names),
           'clipwise_output': rng.rand(3, 25).astype(np.float32),
           'framewise_output': _framewise(4, 3, 1000),
           'target': (rng.rand(3, 25) > 0.7).astype(np.float32)}
    ds = tmp_path / 'ds'
    (ds / 'metadata').mkdir(parents=True)
    with open(ds / 'metadata' / 'groundtruth_strong_label_testing_set.csv',
              'w', newline='') as f:
        csv.writer(f).writerows([[n, 0.5 + i, 3.0 + i, config.LABELS[i]]
                                 for i, n in enumerate(names)])
    results, printed = [], []
    for module, ws in ((cli, tmp_path / 'ws'), (jax_cli, tmp_path / 'wsj')):
        args = module.get_parser().parse_args([
            'calculate_metrics', '--dataset_dir', str(ds), '--workspace',
            str(ws), '--model_type', 'Cnn_9layers_FrameAvg',
            '--audio_16k', '--feature_type', 'gamma'])
        w = Workspace(root=str(ws), model_type='Cnn_9layers_FrameAvg',
                      augmentation='none')
        with open(w.predictions_path('test_predictions_gamma_16k.pkl',
                                     create=True), 'wb') as f:
            pickle.dump(out, f)
        capsys.readouterr()
        results.append(module.calculate_metrics(args))
        printed.append(capsys.readouterr().out)
    assert repr(results[0]) == repr(results[1])
    assert printed[0] == printed[1] and 'SED micro ER' in printed[0]
    assert set(results[0]) == {'clipwise', 'sed'}


# ---------------------------------------------------------------------------
# the wire codecs, savers and file readers of data/audio_io.py and the
# native ADPCM encoder
# ---------------------------------------------------------------------------

def _v6_edge_inputs(samples: int = 16000) -> dict:
    """``tests/test_v6.py``'s edge inputs at 1 s, and a corpus clip."""
    t = np.arange(samples) / 16000
    return {
        'silence': np.zeros(samples, np.float32),
        'dc': np.ones(samples, np.float32),
        'tone440': (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
        'tone7900': (0.9 * np.sin(2 * np.pi * 7900 * t)).astype(np.float32),
        'noise': np.random.RandomState(3).uniform(-1, 1, samples).astype(
            np.float32),
        'int16': (np.random.RandomState(4).uniform(-1, 1, samples)
                  * 32767).astype(np.int16),
        'corpus': bench_corpus.make_clips(1, 16000, seconds=1, seed=6)[0],
    }


@pytest.mark.parametrize('name', sorted(_v6_edge_inputs()))
def test_v6_codec_equals_sed_tpu(name):
    from sed_tpu.data import audio_io as jax_audio_io
    x = _v6_edge_inputs()[name]
    buf = audio_io.v6_encode_clip(x)
    assert np.array_equal(buf, jax_audio_io.v6_encode_clip(x))
    assert len(buf) % 16 == 0 and len(buf) <= audio_io.v6_max_bytes(16000)
    dec = audio_io.v6_decode_np(buf, 16000)
    assert np.array_equal(dec.view(np.int32), jax_audio_io.v6_decode_np(
        buf, 16000).view(np.int32))
    q6 = audio_io.qn_decode_np(audio_io.qn_encode(x[None], 6), 16000, 6)
    assert np.array_equal(dec.view(np.int32), q6[0].view(np.int32))
    for nb in (1, 7, 125, 625):
        assert audio_io.v6_header_bytes(nb) == \
            jax_audio_io.v6_header_bytes(nb)
    assert audio_io.v6_max_bytes(80000) == jax_audio_io.v6_max_bytes(80000)


# saver name -> (port saver, reader, sed_tpu's names); every saver takes
# (path, x, sr), every reader (path)
_CONTAINERS = {
    'wav_mulaw': ('save_wav_mulaw', 'fast_read_wav_mulaw', '.wav'),
    'wav_adpcm': ('save_wav_adpcm', 'fast_read_wav_adpcm', '.wav'),
    'wav_int16': ('save_wav', 'fast_read_wav_int16', '.wav'),
    'q4': ('save_q4', 'read_q4', '.q4'),
    **{f'q{n}': (f'save_q{n}', 'read_qn', f'.q{n}') for n in (2, 3, 5, 6)},
    'v6': ('save_v6', 'read_v6', '.v6'),
    **{f'adpcm{n}': (f'save_adpcm{n}', 'read_adpcm_n', f'.adpcm{n}')
       for n in (2, 3)},
}


def _saver(module, name: str):
    if name.startswith('save_q') and name != 'save_q4':
        return lambda p, x, sr: module.save_qn(p, x, sr, int(name[-1]))
    if name.startswith('save_adpcm') and name[-1].isdigit():
        return lambda p, x, sr: module.save_adpcm_n(p, x, sr, int(name[-1]))
    return getattr(module, name)


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize('fmt', sorted(_CONTAINERS))
def test_savers_and_readers_equal_sed_tpu(tmp_path, fmt):
    """Each saver writes sed_tpu's bytes; each reader gives sed_tpu's
    rows, rate and length from it; ``wire_reader_for`` sniffs the file to
    the same row; float32 and int16 input."""
    from sed_tpu.data import audio_io as jax_audio_io
    save, read, ext = _CONTAINERS[fmt]
    x = bench_corpus.make_clips(1, 16000, seconds=1, seed=8)[0]
    for inp in (x, (x * 32767).astype(np.int16)):
        got, want = str(tmp_path / f'p{ext}'), str(tmp_path / f'j{ext}')
        _saver(audio_io, save)(got, inp, 16000)
        _saver(jax_audio_io, save)(want, inp, 16000)
        assert open(got, 'rb').read() == open(want, 'rb').read()
        assert _same(getattr(audio_io, read)(got),
                     getattr(jax_audio_io, read)(got))
        if fmt in ('wav_mulaw', 'wav_adpcm', 'wav_int16', 'q4', 'q5', 'q6'):
            row = audio_io.wire_reader_for(got)(got)
            assert _same(row, jax_audio_io.wire_reader_for(got)(got))
            assert audio_io._wav_format_tag(got) == \
                jax_audio_io._wav_format_tag(got)
    if fmt == 'v6':
        assert audio_io.v6_payload_bytes(got) == \
            jax_audio_io.v6_payload_bytes(got) == len(audio_io.read_v6(
                got)[0])


def test_wav_readers_and_helpers_equal_sed_tpu(tmp_path):
    """``load_wav_int16`` / ``fast_read_wav_int16`` on a stereo and a
    float wav (the non-canonical paths), a mu-law read of a PCM file (it
    encodes), ``get_duration``, ``trim_silent`` and the q4 aliases."""
    from scipy.io import wavfile
    from sed_tpu.data import audio_io as jax_audio_io
    x = bench_corpus.make_clips(2, 16000, seconds=1, seed=9)
    stereo = str(tmp_path / 'stereo.wav')
    wavfile.write(stereo, 16000, (x.T * 32767).astype(np.int16))
    flt = str(tmp_path / 'float.wav')
    wavfile.write(flt, 8000, x[0])
    for path in (stereo, flt):
        for fn in ('load_wav_int16', 'fast_read_wav_int16',
                   'fast_read_wav_mulaw', 'get_duration'):
            assert _same(getattr(audio_io, fn)(path),
                         getattr(jax_audio_io, fn)(path)), (path, fn)
        assert _same(audio_io.wire_reader_for(path)(path),
                     jax_audio_io.wire_reader_for(path)(path))
    quiet = x[0].copy()
    quiet[4000:9000] *= 1e-3
    for args in ((quiet, 16000), (quiet, 16000, 30.0, 1024, 256),
                 (quiet[:1000], 16000), (np.zeros(5000, np.float32), 16000)):
        assert _same(audio_io.trim_silent(*args),
                     jax_audio_io.trim_silent(*args))
    other = tmp_path / 'notes.txt'
    other.write_text('not a RIFF file')
    assert audio_io._wav_format_tag(str(other)) == \
        jax_audio_io._wav_format_tag(str(other)) == 0
    assert audio_io.q4_bytes(80000) == jax_audio_io.q4_bytes(80000)
    enc = audio_io.q4_encode(x)
    assert np.array_equal(enc, jax_audio_io.q4_encode(x))
    assert np.array_equal(audio_io.q4_decode_np(enc, 16000),
                          jax_audio_io.q4_decode_np(enc, 16000))


@pytest.mark.parametrize('bits', [4, 3, 2])
def test_native_adpcm_encoder_equals_numpy_and_sed_tpu(bits):
    """The port's native encoder (built by g++ into build/) is bit-exact
    to its numpy encoder and to sed_tpu's ``adpcm_encode`` /
    ``adpcm_n_encode``, on float32 and int16 rows of a length no block
    divides."""
    from sed_tpu.data import audio_io as jax_audio_io
    from sed_tpu.native import adpcm_native as jax_adpcm_native
    from sed_tpu_torch.native import adpcm_native
    assert adpcm_native.native_available() == \
        jax_adpcm_native.native_available()
    if not adpcm_native.native_available():
        pytest.skip('no g++ on this host')
    assert adpcm_native._lib_path().startswith(
        os.path.join(REPO, 'build', 'sed_tpu_torch'))
    x = np.concatenate([bench_corpus.make_clips(2, 16000, seconds=1,
                                                seed=10),
                        np.random.RandomState(1).uniform(-1, 1, (1, 16000))
                        .astype(np.float32)])[:, :15999]
    for inp in (x, (x * 32767).astype(np.int16)):
        if bits == 4:
            got = audio_io.adpcm_encode(inp)
            pcm = inp if inp.dtype == np.int16 else np.clip(np.round(
                inp * 32767.0), -32768, 32767).astype(np.int16)
            assert np.array_equal(adpcm_native.encode(pcm, 256), got)
            want = (audio_io.adpcm_encode_np(inp),
                    jax_audio_io.adpcm_encode(inp))
        else:
            got = audio_io.adpcm_n_encode(inp, bits)
            want = (audio_io.adpcm_n_encode_np(inp, bits),
                    jax_audio_io.adpcm_n_encode(inp, bits))
        for w in want:
            assert np.array_equal(got, w)


def test_training_wire_runs_the_native_adpcm_encoder(monkeypatch):
    """The port's ``AudiosetDataset`` encodes ``adpcm4`` batches through
    ``audio_io.adpcm_encode`` (the native encoder where it builds), as
    sed_tpu's does; the bytes are sed_tpu's."""
    from sed_tpu.data.dataset import AudiosetDataset as JaxDataset
    from sed_tpu_torch.data.dataset import AudiosetDataset
    from sed_tpu_torch.native import adpcm_native
    calls = []
    native = adpcm_native.encode
    monkeypatch.setattr(adpcm_native, 'encode',
                        lambda *a: calls.append(1) or native(*a))
    pcm = (np.random.RandomState(2).uniform(-0.5, 0.5, (3, 4000))
           * 32767).astype(np.int16)
    got = AudiosetDataset(wire='adpcm4')._encode_wire(pcm)
    assert np.array_equal(got, JaxDataset(wire='adpcm4')._encode_wire(pcm))
    assert len(calls) == int(adpcm_native.native_available())

