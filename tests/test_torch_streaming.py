"""The port's pipelined and incremental serving paths:
``SedInferenceEngine.predict_clips_stream`` against ``predict_clips``,
and ``StreamingSed`` against ``predict_waveform`` and ``sed_tpu``'s
``StreamingSed``, on the trained bench checkpoint and bench-corpus
audio.

Tolerance: none.  Event lists and XML must be identical (the stream's
events compared as (label, onset, offset) keys rounded to 1e-4 s, as
``tests/test_streaming.py`` does).
"""

import os

import numpy as np
import pytest
import torch

from sed_tpu.config import AUDIO_16K
from sed_tpu.data import audio_io as jax_audio_io
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu.serve import engine as jax_engine
from sed_tpu.serve.streaming import StreamingSed as JaxStreamingSed
from sed_tpu.utils.npz_ckpt import load_variables_npz
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.compat.from_flax import load_npz
from sed_tpu_torch.serve import engine
from sed_tpu_torch.serve.streaming import StreamingSed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
MODEL = 'Cnn_9layers_Gru_FrameAtt'
SR = AUDIO_16K.sample_rate


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes on one
    host, and torch's default of one thread per core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def port():
    return engine.SedInferenceEngine(load_npz(CKPT, MODEL, AUDIO_16K, 'cpu'),
                                     AUDIO_16K, 'cpu', sample_duration=5,
                                     overlap=True, batch_size=8)


@pytest.fixture(scope='module')
def ref():
    # batch 2: sed_tpu pads every forward to its batch, and a feed
    # completes one or two windows
    return jax_engine.SedInferenceEngine(
        jax_get_model(MODEL, AUDIO_16K), load_variables_npz(CKPT),
        AUDIO_16K, sample_duration=5, overlap=True, batch_size=2)


@pytest.fixture(scope='module')
def pcm():
    clips = make_clips(10, SR, seconds=5, seed=2)
    return (np.clip(clips, -1, 1) * 32767).astype(np.int16)


def _chunks(wavs, size):
    for i in range(0, len(wavs), size):
        yield wavs[i:i + size]


NAMES = [f'n{i}.wav' for i in range(10)]


@pytest.fixture(scope='module')
def batch_result(port, pcm):
    return port.predict_clips(pcm, NAMES)


@pytest.mark.parametrize('size', [1, 3, 8])
def test_predict_clips_stream_equals_predict_clips(port, pcm, batch_result,
                                                   size):
    """10 clips in chunks of 1, 3 (3+3+3+1) and 8 (8+2): the last chunk
    is ragged for 3 and 8."""
    assert sum(map(len, batch_result[0])) > 0
    assert port.predict_clips_stream(_chunks(pcm, size), NAMES) == \
        batch_result


def test_predict_clips_stream_default_names(port, pcm):
    assert port.predict_clips_stream(_chunks(pcm[:4], 3)) == \
        port.predict_clips(pcm[:4])


def test_predict_clips_stream_on_a_wire(port, pcm):
    buf = jax_audio_io.adpcm_encode(pcm)
    assert port.predict_clips_stream(_chunks(buf, 3)) == \
        port.predict_clips(buf)


def test_predict_clips_stream_raises_the_iterators_exception(port, pcm):
    def failing():
        yield pcm[:3]
        yield pcm[3:6]
        raise KeyError('reader failed')

    with pytest.raises(KeyError, match='reader failed'):
        port.predict_clips_stream(failing())
    with pytest.raises(ValueError, match='batch_size'):
        port.predict_clips_stream(_chunks(pcm, 9))
    with pytest.raises(ValueError, match='80000'):
        port.predict_clips_stream(iter([pcm[:2, :1000]]))


def test_predict_clips_stream_closes_the_iterator_when_it_stops(port, pcm):
    """A chunk over batch_size stops the call: the caller's generator is
    closed (its finally ran) before the call returns, and it was not
    drained."""
    pulled, closed = [], []

    def reader():
        try:
            for i in range(100):
                pulled.append(i)
                yield pcm[:9] if i == 1 else pcm[:2]
        finally:
            closed.append(len(pulled))

    chunks = reader()           # held here, so only a close() ends it
    with pytest.raises(ValueError, match='batch_size'):
        port.predict_clips_stream(chunks)
    assert closed == [len(pulled)] and len(pulled) < 10


def _key(e):
    return (e['event_label'], round(e['onset'], 4), round(e['offset'], 4))


@pytest.fixture(scope='module')
def audio():
    """12 s of bench-corpus audio (three 4 s clips, events everywhere)."""
    clips = make_clips(3, SR, seconds=4, seed=9)
    return np.ascontiguousarray(clips.reshape(-1), np.float32)


def _sizes(pattern, n):
    if pattern == 'tiny':
        return [int(0.37 * SR)] * (n // int(0.37 * SR) + 1)
    if pattern == 'medium':
        return [int(2.3 * SR)] * (n // int(2.3 * SR) + 1)
    if pattern == 'one_shot':
        return [n]
    rng = np.random.RandomState(0)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.uniform(0.05, 3.0) * SR))
    return sizes


def _stream(sess, audio, sizes):
    got, early, pos = [], [], 0
    for s in sizes:
        evs = sess.feed(audio[pos:pos + s])
        got.extend(evs)
        early.extend(evs)
        pos += s
        if pos >= len(audio):
            break
    got.extend(sess.flush())
    return got, early


@pytest.fixture(scope='module')
def offline(port, audio):
    return sorted(_key(e) for e in port.predict_waveform(audio, 'stream'))


@pytest.mark.parametrize('pattern', ['tiny', 'medium', 'one_shot',
                                     'random'])
def test_stream_equals_offline_and_sed_tpu(port, ref, audio, offline,
                                           pattern):
    want = offline
    assert want, 'the bench checkpoint finds events in this audio'
    got, early = _stream(StreamingSed(port, 'stream'), audio,
                         _sizes(pattern, len(audio)))
    assert sorted(_key(e) for e in got) == want
    assert set(_key(e) for e in early) <= set(want)
    jax_got, jax_early = _stream(JaxStreamingSed(ref, 'stream'), audio,
                                 _sizes(pattern, len(audio)))
    assert sorted(_key(e) for e in jax_got) == want
    assert sorted(map(_key, early)) == sorted(map(_key, jax_early))
    if pattern in ('tiny', 'medium', 'random'):
        assert early, 'no events finalized before flush'


def test_stream_shorter_than_one_window(port, ref):
    short = make_clips(1, SR, seconds=5, seed=10)[0][:2 * SR]
    want = sorted(_key(e) for e in port.predict_waveform(short, 'stream'))
    sess = StreamingSed(port, 'stream')
    assert sess.feed(short) == []
    got = sorted(_key(e) for e in sess.flush())
    assert got == want
    jax_sess = JaxStreamingSed(ref, 'stream')
    jax_sess.feed(short)
    assert sorted(_key(e) for e in jax_sess.flush()) == got


def test_stream_rejects_double_flush_and_feed_after_flush(port):
    sess = StreamingSed(port)
    sess.feed(np.zeros(SR, np.float32))
    sess.flush()
    with pytest.raises(AssertionError):
        sess.flush()
    with pytest.raises(AssertionError):
        sess.feed(np.zeros(10, np.float32))


def test_stream_drops_consumed_audio(port, audio):
    """Audio before the next window's start is dropped: what the session
    keeps stays under a window plus a chunk, however long the stream."""
    sess = StreamingSed(port, 'stream')
    chunk = int(0.5 * SR)
    for pos in range(0, len(audio), chunk):
        sess.feed(audio[pos:pos + chunk])
        kept = sum(len(c) for c in sess._chunks)
        assert kept <= port.window_samples + chunk
        assert sess._base + kept == min(pos + chunk, len(audio))
    assert sess._base >= len(audio) - port.window_samples - chunk
    assert sess._base == (sess._next_start * SR) // chunk * chunk


def test_stream_needs_the_overlapped_grid():
    model = load_npz(CKPT, MODEL, AUDIO_16K, 'cpu')
    eng = engine.SedInferenceEngine(model, AUDIO_16K, 'cpu', overlap=False)
    with pytest.raises(AssertionError, match='overlap'):
        StreamingSed(eng)
