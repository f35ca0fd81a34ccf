"""The port's spans and counters (``utils/profiling.span``, the
``sed::`` spans of ``serve/engine.py``, ``serve/streaming.py`` and
``train/prefetch.py``, ``StreamingSed.frames_decoded`` and
``frames_streamed``) and the benchmark's reader of them
(``bench_h100/spans.py``), on the CPU.

The serving and streaming cases run the trained bench checkpoint
(Cnn_9layers_Gru_FrameAtt, 16 kHz) on bench-corpus clips.
"""

import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_h100 import harness, spans
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.compat.from_flax import load_npz
from sed_tpu_torch.config import AUDIO_16K
from sed_tpu_torch.serve import engine as engine_mod
from sed_tpu_torch.serve.streaming import StreamingSed
from sed_tpu_torch.train.prefetch import device_prefetch
from sed_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
SR = AUDIO_16K.sample_rate
BATCH = 2


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def port():
    return engine_mod.SedInferenceEngine(
        load_npz(CKPT, 'Cnn_9layers_Gru_FrameAtt', AUDIO_16K, 'cpu'),
        AUDIO_16K, 'cpu', sample_duration=5, overlap=True,
        batch_size=BATCH)


@pytest.fixture(scope='module')
def pcm():
    clips = make_clips(2 * BATCH, SR, seconds=5, seed=4)
    return (np.clip(clips, -1, 1) * 32767).astype(np.int16)


def _profiled(fn):
    """(fn's result, the ``sed::`` host events it recorded, in start
    order) under a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e for e in prof.events() if e.name.startswith('sed::')),
                    key=lambda e: e.time_range.start)
    return out, events, prof


def test_span_is_a_host_op_that_nests(tmp_path):
    def body():
        with profiling.span('outer'):
            with profiling.span('inner'):
                torch.zeros(4).add_(1)
    _, events, prof = _profiled(body)
    assert [e.name for e in events] == ['sed::outer', 'sed::inner']
    outer, inner = events
    assert not outer.is_user_annotation and not inner.is_user_annotation
    assert inner.cpu_parent is outer
    assert outer.time_range.start <= inner.time_range.start \
        <= inner.time_range.end <= outer.time_range.end
    # in the Chrome trace a span is a host operator, not an annotation
    # (the profiler mirrors annotations onto the device's timeline)
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        cats = {e['name']: e.get('cat') for e in json.load(f)['traceEvents']
                if e.get('name', '').startswith('sed::')}
    assert cats == {'sed::outer': 'cpu_op', 'sed::inner': 'cpu_op'}


@pytest.mark.parametrize('into', [False, True])
def test_span_without_a_profiler_records_nothing(monkeypatch, into):
    made = []
    monkeypatch.setattr(profiling, '_HostOp',
                        lambda name: made.append(name))
    times = {'pull_s': 0.5} if into else None
    t0 = time.perf_counter()
    for _ in range(2):
        with profiling.span('serve.pull', times, 'pull_s'):
            time.sleep(0.01)
    took = time.perf_counter() - t0
    assert made == []
    if into:
        # each block's seconds added to what the key held
        assert 0.5 + 0.02 <= times['pull_s'] <= 0.5 + took


def test_predict_clips_spans_each_stage_in_order(port, pcm):
    (events, xmls), got, _ = _profiled(lambda: port.predict_clips(pcm))
    assert len(xmls) == len(pcm)
    assert [e.name[len('sed::serve.'):] for e in got] == \
        ['upload', 'forward'] * 2 + ['pull', 'decode', 'xml']
    # one after another on the calling thread, none nested in another
    assert len({e.thread for e in got}) == 1
    assert all(a.time_range.end <= b.time_range.start
               for a, b in zip(got, got[1:]))


@pytest.fixture(scope='module')
def resident_traced(port, pcm):
    tel = {}
    (_, _), got, _ = _profiled(
        lambda: port.predict_clips_resident(pcm, telemetry=tel))
    return tel, got


@pytest.mark.parametrize('key,stages', [
    ('upload_s', ('upload',)), ('launch_s', ('forward',)),
    ('pull_s', ('pull',)), ('decode_s', ('decode', 'xml'))])
def test_resident_telemetry_is_read_at_the_span_boundaries(
        resident_traced, key, stages):
    tel, got = resident_traced
    assert set(tel) == {'read_s', 'upload_s', 'launch_s', 'pull_s',
                        'decode_s', 'bytes_h2d', 'bytes_d2h', 'n_batches'}
    assert [e.name for e in got] == [
        f'sed::serve.{s}' for s in
        ['upload'] + ['forward'] * 2 + ['pull', 'decode', 'xml']]
    mine = [e.time_range.elapsed_us() / 1e6 for e in got
            if e.name[len('sed::serve.'):] in stages]
    # the host clock read just inside each of the key's spans
    assert 0 < tel[key] and abs(tel[key] - sum(mine)) <= 1e-3 * len(mine)


def _closed_form(seconds: int, t_win: int, hop: int, window_s: int):
    """(frames decoded, frames streamed) of one stream of ``seconds`` s
    fed in 1 s chunks: after the k-th feed the windows starting at
    0 .. k - window_s are in, so t_win + (k - window_s) hop frames are
    merged, of which all but the last window_s hop - hop are final and
    decoded again; flush decodes the whole stream once more."""
    total = t_win + (seconds - window_s) * hop
    prefix = sum(max(0, t_win + (k - window_s) * hop
                     - (window_s * hop - hop))
                 for k in range(window_s, seconds + 1))
    return prefix + total, total


def test_stream_spans_each_call_and_counts_its_decoded_frames(port):
    seconds = 8
    audio = make_clips(1, SR, seconds=seconds, seed=6)[0]
    before = StreamingSed.frames_decoded, StreamingSed.frames_streamed

    def stream():
        live = StreamingSed(port)
        out = [live.feed(audio[i:i + SR]) for i in range(0, len(audio), SR)]
        return out + [live.flush()]
    _, got, _ = _profiled(stream)
    calls = [e for e in got if e.name in ('sed::stream.feed',
                                          'sed::stream.flush')]
    assert [e.name for e in calls] == \
        ['sed::stream.feed'] * seconds + ['sed::stream.flush']
    inner = [e for e in got if e.name in ('sed::stream.forward',
                                          'sed::stream.decode')]
    # every forward and decode runs inside one call: a forward on each
    # feed from the fifth (one window each), a decode on each feed that
    # finalises frames and one on the flush
    assert all(e.cpu_parent.name in ('sed::stream.feed', 'sed::stream.flush')
               for e in inner)
    assert sum(e.name == 'sed::stream.forward' for e in inner) == seconds - 4
    assert [e.cpu_parent.name for e in inner
            if e.name == 'sed::stream.decode'][-1] == 'sed::stream.flush'
    decoded, streamed = _closed_form(
        seconds, port._out_frames, int(AUDIO_16K.frames_per_second), 5)
    assert (StreamingSed.frames_decoded - before[0],
            StreamingSed.frames_streamed - before[1]) == (decoded, streamed)
    # the benchmark's 120 s stream: 500-frame windows at a 100-frame hop
    assert _closed_form(120, 500, 100, 5) == (690600, 12000)


def test_batch_wait_span_is_on_the_consuming_thread():
    batches = [np.full(3, i, np.float32) for i in range(3)]

    def consume():
        torch.zeros(1)                   # an operator on this thread
        return [int(b[0]) for b in device_prefetch(iter(batches),
                                                   device='cpu')]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = consume()
    assert got == [0, 1, 2]
    events = list(prof.events())
    mine = {e.thread for e in events if e.name == 'aten::zeros'}
    waits = [e for e in events if e.name == 'sed::train.batch_wait']
    # one wait a batch and one for the end of the stream
    assert len(waits) == 4
    assert {e.thread for e in waits} == mine


def _trace(host, gaps, thread=1):
    ev = [types.SimpleNamespace(name=name, thread=th,
                                time_range=types.SimpleNamespace(
                                    start=s, end=e))
          for name, th, s, e in host]
    return types.SimpleNamespace(host=ev, thread=thread,
                                 idle_gaps=lambda: list(gaps))


# device idle in [0, 10], [20, 30], [40, 60]; the gap [20, 30] straddles
# the end of the first upload span, [40, 60] the start of the decode
SYNTHETIC = _trace(
    [('sed::serve.upload', 1, 5, 25), ('sed::serve.upload', 1, 45, 50),
     ('sed::serve.decode', 1, 55, 70), ('sed::serve.xml', 1, 56, 58),
     ('sed::serve.decode', 2, 0, 100),          # another thread: not read
     ('aten::copy_', 1, 0, 100)],
    [(0, 10), (20, 30), (40, 60)])


@pytest.mark.parametrize('names,idle,host,count', [
    (('serve.upload',), 5 + 5 + 5, 20 + 5, 2),
    (('serve.decode',), 5, 15, 1),
    (('serve.decode', 'serve.xml'), 5, 15, 2),
    (('serve.upload', 'serve.decode', 'serve.xml'), 20, 40, 4),
    (('serve.read',), None, None, 0)])
def test_idle_under_spans_is_the_exact_overlap(names, idle, host, count):
    assert spans.idle_us(SYNTHETIC, *names) == idle
    assert spans.host_us(SYNTHETIC, *names) == host
    assert spans.count(SYNTHETIC, *names) == count


def test_overlap_of_interval_lists():
    a = [(0, 10), (20, 30), (40, 60)]
    assert spans.overlap_us(a, [[5, 45]]) == 5 + 10 + 5
    assert spans.overlap_us(a, [[10, 20], [30, 40]]) == 0
    assert spans.overlap_us(a, [[-5, 100]]) == 40


# what each new reader reads off a synthetic run of its kind: (info,
# host spans, idle gaps, the value worked out by hand, in ms)
READERS = {
    'upload_idle_ms_per_clip.serve': (
        {'kind': 'serve', 'traced_clips': 5}, SYNTHETIC, 15 / 1e3 / 5),
    'decode_idle_ms_per_clip.serve': (
        {'kind': 'serve', 'traced_clips': 5}, SYNTHETIC, 5 / 1e3 / 5),
    'forward_ms_per_call.stream': (
        {'kind': 'stream'}, _trace(
            [('sed::stream.feed', 1, 0, 10), ('sed::stream.feed', 1, 10, 30),
             ('sed::stream.flush', 1, 30, 40),
             ('sed::stream.forward', 1, 2, 6),
             ('sed::stream.forward', 1, 12, 20),
             ('sed::stream.decode', 1, 7, 9),
             ('sed::stream.decode', 1, 32, 38)], []), 12 / 1e3 / 3),
    'decode_ms_per_call.stream': (
        {'kind': 'stream'}, _trace(
            [('sed::stream.feed', 1, 0, 10), ('sed::stream.flush', 1, 30, 40),
             ('sed::stream.decode', 1, 7, 9),
             ('sed::stream.decode', 1, 32, 38)], []), 8 / 1e3 / 2),
    'batch_wait_ms_per_step.train': (
        {'kind': 'train', 'traced_clips': 512, 'clips_per_step': 256},
        _trace([('sed::train.batch_wait', 1, 0, 3),
                ('sed::train.batch_wait', 1, 10, 12)], []), 5 / 1e3 / 2),
}


def _reader(name):
    return harness.load_module(
        os.path.join(REPO, 'bench_h100', 'metrics', f'{name}.py'),
        f'test_metric_{name}')


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_reads_the_programs_spans(name):
    info, trace, want = READERS[name]
    got = _reader(name).read(types.SimpleNamespace(trace=trace, info=info))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize('name', sorted(READERS))
def test_reader_is_silent_on_a_program_without_spans(name):
    """A program without the spans (the benchmark's parent) reports
    nothing; a run of another kind neither."""
    info, trace, _ = READERS[name]
    reader = _reader(name)
    bare = _trace([(e.name.replace('sed::', 'aten::'), e.thread,
                    e.time_range.start, e.time_range.end)
                   for e in trace.host], [(0, 100)])
    assert reader.read(types.SimpleNamespace(trace=bare, info=info)) is None
    other = dict(info, kind='other')
    assert reader.read(types.SimpleNamespace(trace=trace, info=other)) \
        is None


def test_decode_redo_reads_the_stream_counters(monkeypatch):
    reader = _reader('decode_redo.stream')
    run = types.SimpleNamespace(trace=None, info={'kind': 'stream'})
    monkeypatch.setattr(StreamingSed, 'frames_decoded', 690600 + 3100)
    monkeypatch.setattr(StreamingSed, 'frames_streamed', 12000 + 1000)
    assert reader.read(run) == (690600 + 3100) / (12000 + 1000)
    assert reader.read(types.SimpleNamespace(
        trace=None, info={'kind': 'serve'})) is None
    # a program without the counters, or no stream flushed yet
    monkeypatch.setattr(StreamingSed, 'frames_streamed', 0)
    assert reader.read(run) is None
    monkeypatch.delattr(StreamingSed, 'frames_streamed')
    monkeypatch.delattr(StreamingSed, 'frames_decoded')
    assert reader.read(run) is None
    monkeypatch.delitem(sys.modules, 'sed_tpu_torch.serve.streaming')
    assert reader.read(run) is None
