"""The port's resident serving paths against ``predict_clips`` and against
``sed_tpu``'s engine: ``predict_clips_resident`` and
``predict_files_resident`` over the six fixed-width file formats
(``audio_io.wire_reader_for``), the ragged v6 pass
(``predict_files_resident_ragged``, ``predict_rows_resident``) against
the q6 wire, ``predict --resident`` and ``predict_asr`` through the CLIs
of both packages, and ``utils/profiling.trace``.

The model is the trained bench checkpoint (Cnn_9layers_Gru_FrameAtt,
16 kHz) at batch 8 on ``tests/test_torch_wire.py``'s eight 5 s
bench-corpus clips, on the CPU.

Tolerance: none.  Events and XML must be identical.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sed_tpu.cli import predict as jax_predict_cli
from sed_tpu.config import AUDIO_16K
from sed_tpu.data import audio_io as jax_audio_io
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu.serve import engine as jax_engine
from sed_tpu.utils.npz_ckpt import load_variables_npz
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.cli import predict as predict_cli
from sed_tpu_torch.compat.from_flax import load_npz
from sed_tpu_torch.data import audio_io
from sed_tpu_torch.ops import wire
from sed_tpu_torch.serve import engine
from sed_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
MODEL = 'Cnn_9layers_Gru_FrameAtt'
SR = AUDIO_16K.sample_rate
N = 8


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes on one
    host, and torch's default of one thread per core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_engine(batch_size: int = N, **kw):
    return jax_engine.SedInferenceEngine(
        jax_get_model(MODEL, AUDIO_16K), load_variables_npz(CKPT), AUDIO_16K,
        batch_size=batch_size, **kw)


@pytest.fixture(scope='module')
def engines():
    port = engine.SedInferenceEngine(load_npz(CKPT, MODEL, AUDIO_16K, 'cpu'),
                                     AUDIO_16K, 'cpu', sample_duration=5,
                                     overlap=True, batch_size=N)
    return _jax_engine(sample_duration=5, overlap=True), port


@pytest.fixture(scope='module')
def clips():
    return make_clips(N, SR, seconds=5, seed=0)


# format -> (saver of one clip, the wire rows of the clips in memory)
FORMATS = {
    'int16': (audio_io.save_wav,
              lambda x: (np.clip(x, -1, 1) * 32767).astype(np.int16)),
    'mulaw': (audio_io.save_wav_mulaw, audio_io.mulaw_encode),
    'adpcm4': (audio_io.save_wav_adpcm, audio_io.adpcm_encode),
    **{f'q{n}': (lambda p, x, sr, n=n: audio_io.save_qn(p, x, sr, n),
                 lambda x, n=n: audio_io.qn_encode(x, n))
       for n in (4, 5, 6)},
}
EXT = {'q4': '.q4', 'q5': '.q5', 'q6': '.q6', 'v6': '.v6'}


@pytest.fixture(scope='module')
def corpus(tmp_path_factory, clips):
    """The clips written in every format, one directory a format."""
    root = tmp_path_factory.mktemp('corpus')
    dirs = {}
    for fmt, (save, _) in {**FORMATS, 'v6': (audio_io.save_v6, None)}.items():
        d = root / fmt
        d.mkdir()
        for i, x in enumerate(clips):
            save(str(d / f'c{i}{EXT.get(fmt, ".wav")}'), x, SR)
        dirs[fmt] = d
    return dirs


def _paths(d) -> list:
    return sorted(str(p) for p in d.iterdir())


NAMES = [f'c{i}.wav' for i in range(N)]


def _traced(fn):
    """(fn's result, the ``sed::serve.*`` stages it spanned, in order)
    under a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name[len('sed::serve.'):] for e in sorted(
        (e for e in prof.events() if e.name.startswith('sed::serve.')),
        key=lambda e: e.time_range.start)]


def _count_uploads(monkeypatch, port) -> list:
    """The bytes of each pinned pass buffer ``port`` uploads from now
    on, in order."""
    sizes = []
    upload = port._upload

    def counted(host):
        sizes.append(host.nbytes)
        return upload(host)
    monkeypatch.setattr(port, '_upload', counted)
    return sizes


@pytest.fixture(scope='module')
def q6_result(engines, clips):
    return engines[1].predict_clips(FORMATS['q6'][1](clips), NAMES)


@pytest.mark.parametrize('fmt', sorted(FORMATS))
def test_resident_passes_identical_to_predict_clips_and_sed_tpu(
        engines, clips, corpus, fmt, monkeypatch):
    """Files of each format through ``wire_reader_for``: the port's
    ``predict_files_resident`` (three reader threads) and
    ``predict_clips_resident`` on the same wire rows equal its
    ``predict_clips`` and sed_tpu's ``predict_files_resident``."""
    ref, port = engines
    paths = _paths(corpus[fmt])
    names = [os.path.basename(p) for p in paths]
    reader = audio_io.wire_reader_for(paths[0])
    rows = np.stack([reader(p) for p in paths])
    if fmt != 'adpcm4':            # the wav carries no pad byte
        assert np.array_equal(rows, FORMATS[fmt][1](clips))
    uploaded = _count_uploads(monkeypatch, port)
    got, stages = _traced(lambda: port.predict_files_resident(
        paths, reader, upload_threads=3))
    assert sum(map(len, got[0])) > 0
    assert got == port.predict_clips(rows, names)
    assert got == port.predict_clips_resident(rows, names)
    assert got == ref.predict_files_resident(
        paths, jax_audio_io.wire_reader_for(paths[0]), upload_threads=3)
    assert uploaded[0] == rows.nbytes and stages.count('forward') == 1


@pytest.mark.parametrize('max_pass', [3, 5])
def test_max_pass_clips_gives_one_pass_results(engines, corpus, max_pass):
    _, port = engines
    paths = _paths(corpus['adpcm4'])
    reader = audio_io.wire_reader_for(paths[0])
    one = port.predict_files_resident(paths, reader)
    got, stages = _traced(lambda: port.predict_files_resident(
        paths, reader, max_pass_clips=max_pass))
    assert got == one
    # one upload a pass, and one batch a pass
    assert stages.count('upload') == -(-N // max_pass)
    assert stages.count('forward') == stages.count('upload')
    with pytest.raises(ValueError, match='max_pass_clips'):
        port.predict_files_resident(paths, reader, max_pass_clips=0)


@pytest.mark.parametrize('entry', ['files', 'rows'])
def test_ragged_v6_gives_the_q6_results(engines, clips, corpus, q6_result,
                                        entry, monkeypatch):
    """v6 files (``read_v6``) and in-memory payloads: the results of the
    q6 wire in the port and in sed_tpu's ragged pass."""
    ref, port = engines
    paths = _paths(corpus['v6'])
    if entry == 'files':
        uploaded = _count_uploads(monkeypatch, port)
        got = port.predict_files_resident_ragged(
            paths, lambda p: audio_io.read_v6(p)[0], names=NAMES,
            upload_threads=3)
        # the pool: exactly the true bytes and the zero tail
        assert uploaded == [sum(audio_io.v6_payload_bytes(p)
                                for p in paths)
                            + 4 * port._RAGGED_TAIL_WORDS]
        want = ref.predict_files_resident_ragged(
            paths, lambda p: jax_audio_io.read_v6(p)[0], names=NAMES)
    else:
        rows = [audio_io.v6_encode_clip(x) for x in clips]
        got = port.predict_rows_resident(rows, NAMES)
        want = ref.predict_rows_resident(rows, NAMES)
    assert got == q6_result == want
    assert sum(map(len, got[0])) > 0


def test_resident_paths_refuse_what_they_do_not_take(engines, clips):
    _, port = engines
    with pytest.raises(ValueError, match='80000'):
        port.predict_clips_resident(np.zeros((2, 30000), np.uint8))
    with pytest.raises(ValueError, match='empty'):
        port.predict_files_resident([], audio_io.read_qn)
    with pytest.raises(ValueError, match='16-byte'):
        port.predict_rows_resident([np.zeros(20, np.uint8)])
    rows = FORMATS['q6'][1](clips[:2])
    with pytest.raises(ValueError, match='wire row'):
        port.predict_files_resident(
            [0, 1], lambda i: rows[i] if i == 0 else rows[i][:-2],
            names=['a', 'b'])
    two = engine.SedInferenceEngine(port.model, AUDIO_16K, 'cpu',
                                    batch_size=N, devices=['cpu', 'cpu'])
    with pytest.raises(ValueError, match='one device'):
        two.predict_clips_resident(rows)


def test_zero_clips_resident_give_no_results(engines):
    """A (0, 80000) int16 pass: ``([], [])`` from both packages'
    ``predict_clips_resident``, no batch run."""
    ref, port = engines
    empty = np.zeros((0, 80000), np.int16)
    got, stages = _traced(lambda: port.predict_clips_resident(empty))
    assert got == ([], [])
    assert 'forward' not in stages and 'pull' not in stages
    assert ref.predict_clips_resident(empty) == ([], [])


def test_warmup_and_measure_forward_ms(engines, clips):
    _, port = engines
    port.warmup(FORMATS['q6'][1](clips))
    with pytest.raises(AssertionError):
        port.warmup(FORMATS['q6'][1](clips[:3]))


def _predict_argv(in_dir, ws, *extra):
    return ['predict', '--workspace', str(ws), '--input_dir', str(in_dir),
            '--audio_16k', '--checkpoint', CKPT, '--device', 'cpu',
            '--batch_size', str(N), *extra]


@pytest.mark.parametrize('fmt', ['int16', 'q6'])
def test_cli_resident_writes_the_engine_xml(engines, corpus, tmp_path, fmt):
    """``predict --resident --device cpu`` writes, for every file, the XML
    of the engine's resident pass; a negative ``--max_pass_clips``
    exits, as in sed_tpu."""
    ref, port = engines
    paths = _paths(corpus[fmt])
    _, xmls = ref.predict_files_resident(
        paths, jax_audio_io.wire_reader_for(paths[0]))
    ws = tmp_path / 'ws'
    predict_cli.main(_predict_argv(corpus[fmt], ws, '--resident',
                                   '--upload_threads', '2',
                                   '--max_pass_clips', '5'))
    for path, xml in zip(paths, xmls):
        stem = os.path.splitext(os.path.basename(path))[0]
        assert (ws / 'predict_results' / f'{stem}.xml').read_text() == xml
    with pytest.raises(SystemExit):
        predict_cli.main(_predict_argv(corpus[fmt], ws, '--resident',
                                       '--max_pass_clips', '-1'))


class _FakeRecognizer:
    """Every other segment is not understood (``UnknownValueError``)."""

    def __init__(self):
        self.calls = 0

    def record(self, source):
        return source.path

    def recognize_google(self, audio_data, language='en-SG'):
        self.calls += 1
        if self.calls % 2 == 0:
            raise sys.modules['speech_recognition'].UnknownValueError()
        return f'words {self.calls} ({language})'


class _FakeAudioFile:
    def __init__(self, path):
        self.path = path

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _fake_speech_recognition(monkeypatch):
    fake = types.ModuleType('speech_recognition')
    fake.Recognizer = _FakeRecognizer
    fake.AudioFile = _FakeAudioFile
    fake.UnknownValueError = type('UnknownValueError', (Exception,), {})
    fake.RequestError = type('RequestError', (Exception,), {})
    monkeypatch.setitem(sys.modules, 'speech_recognition', fake)


def test_predict_asr_writes_sed_tpus_xml(tmp_path, monkeypatch):
    """Both packages' ``predict_asr`` on the same files and weights under
    one fake ``speech_recognition`` and a stubbed ffmpeg cutter: the same
    cuts and identical XML, speech events with ``text=``.  sed_tpu's CLI
    reads no .npz, so its engine is built from the same weights by
    hand."""
    import subprocess
    _fake_speech_recognition(monkeypatch)
    in_dir = tmp_path / 'in'
    in_dir.mkdir()
    # two corpus clips in which the model finds child speech
    for i, x in enumerate(make_clips(16, SR, seconds=5, seed=11)[4:6]):
        audio_io.save_wav(str(in_dir / f'a{i}.wav'), x, SR)
    cuts = {'port': [], 'jax': []}
    monkeypatch.setattr(
        jax_predict_cli, '_build_engine',
        lambda args, cfg, ws: _jax_engine(
            batch_size=args.batch_size, sample_duration=args.sample_duration,
            overlap=args.overlap, overlap_value=args.overlap_value))
    xml = {}

    def cutter(cut: list):
        def run(argv, **kw):         # the temporary file's name dropped
            cut.append(argv[:-1])
            return types.SimpleNamespace(returncode=0)
        return run

    for pkg, cli, extra in (('port', predict_cli, ['--checkpoint', CKPT,
                                                   '--device', 'cpu']),
                            ('jax', jax_predict_cli, [])):
        monkeypatch.setattr(subprocess, 'run', cutter(cuts[pkg]))
        ws = tmp_path / pkg
        cli.main(['predict_asr', '--workspace', str(ws), '--input_dir',
                  str(in_dir), '--audio_16k', '--overlap', '--batch_size',
                  '4', '--asr_language', 'en-US', *extra])
        xml[pkg] = [(ws / 'predict_results' / f'a{i}.xml').read_text()
                    for i in range(2)]
    assert cuts['port'] == cuts['jax'] and cuts['port']
    assert xml['port'] == xml['jax']
    assert 'text="words 1 (en-US)"' in xml['port'][0]


def test_predict_asr_without_the_package_exits(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'speech_recognition', None)
    argv = ['predict_asr', '--workspace', str(tmp_path), '--input_dir',
            str(tmp_path), '--audio_16k']
    for cli, extra in ((predict_cli, ['--device', 'cpu']),
                       (jax_predict_cli, [])):
        with pytest.raises(SystemExit, match='speech_recognition'):
            cli.main(argv + extra)


def test_trace_writes_a_chrome_trace(tmp_path):
    import json
    with profiling.trace(str(tmp_path / 'trace')):
        wire.dequant_wire(torch.zeros(2, 256, dtype=torch.int16))
    files = os.listdir(tmp_path / 'trace')
    assert len(files) == 1 and files[0].endswith('.json')
    with open(tmp_path / 'trace' / files[0]) as f:
        events = json.load(f)['traceEvents']
    assert any('aten::' in e.get('name', '') for e in events)
