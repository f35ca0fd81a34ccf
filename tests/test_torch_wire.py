"""The uint8 wires of sed_tpu_torch (``ops/wire.py``) against ``sed_tpu``:
the device decode against ``sed_tpu.ops.wire.dequant_wire`` (JAX on the
CPU) and against ``sed_tpu``'s numpy decoders, the v6 pool decode
against ``sed_tpu.ops.wire.dequant_v6_pool``, and the engine's
``predict_clips`` on each wire against ``sed_tpu``'s engine on the same
buffers.

Tolerance: none.  Decodes are compared bitwise (``np.array_equal`` of
the float32 bit patterns); events and XML must be identical.  The
buffers are made by ``sed_tpu``'s encoders: the port only decodes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sed_tpu.config import AUDIO_16K
from sed_tpu.data import audio_io as jax_audio_io
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu.ops import wire as jax_wire
from sed_tpu.serve import engine as jax_engine
from sed_tpu.utils.npz_ckpt import load_variables_npz
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.data import audio_io
from sed_tpu_torch.compat.from_flax import load_npz
from sed_tpu_torch.ops import wire
from sed_tpu_torch.ops.logmel_kernel import fused_logmel
from sed_tpu_torch.serve import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
MODEL = 'Cnn_9layers_Gru_FrameAtt'


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes on one
    host, and torch's default of one thread per core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


ENCODERS = {
    **{f'q{n}': (lambda x, n=n: jax_audio_io.qn_encode(x, n),
                 lambda b, s, n=n: jax_audio_io.qn_decode_np(b, s, n))
       for n in jax_audio_io.QN_BITS},
    'mulaw': (jax_audio_io.mulaw_encode, lambda b, s: jax_audio_io
              .mulaw_decode(b)),
    'adpcm4': (jax_audio_io.adpcm_encode, jax_audio_io.adpcm_decode_np),
    **{f'adpcm{n}': (lambda x, n=n: jax_audio_io.adpcm_n_encode(x, n),
                     lambda b, s, n=n: jax_audio_io.adpcm_n_decode_np(
                         b, s, n))
       for n in (3, 2)},
}


def _signals(samples: int) -> np.ndarray:
    """Seeded noise (with a bench-corpus clip's content), a full-scale
    +-1 square wave and digital silence."""
    rng = np.random.RandomState(samples)
    noise = np.clip(rng.standard_normal(samples) * 0.3, -1, 1)
    corpus = make_clips(1, 16000, seconds=5, seed=1)[0]
    noise[:min(samples, corpus.size)] += corpus[:samples]
    square = np.where((np.arange(samples) // 37) % 2 == 0, 1.0, -1.0)
    return np.clip(np.stack([noise, square, np.zeros(samples)]),
                   -1, 1).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# 80000: 5 s at 16 kHz; 64640 = 128 x 505 = 96 x 673 + 32: the adpcm4
# block divides it, the adpcm3/2 blocks do not (nor do they 80000)
@pytest.mark.parametrize('samples', [80000, 64640])
@pytest.mark.parametrize('name', sorted(ENCODERS))
def test_dequant_wire_bitwise_equal_to_sed_tpu(name, samples):
    encode, decode_np = ENCODERS[name]
    x = _signals(samples)
    buf = encode(x)
    assert buf.dtype == np.uint8
    got = wire.dequant_wire(torch.from_numpy(buf), samples)
    assert got.dtype == torch.float32 and got.shape == (3, samples)
    got = got.numpy()
    assert np.array_equal(_bits(got), _bits(decode_np(buf, samples)))
    if samples == 80000:            # one JAX compile per wire is enough
        want = jax_wire.dequant_wire(jnp.asarray(buf), samples)
        assert np.array_equal(_bits(got), _bits(want))
    # silence stays silent (adpcm2 cannot code a zero step: +-1 LSB)
    assert np.abs(got[2]).max() <= 1e-4
    assert np.abs(got[1]).max() > 0.9            # full scale survives


PORT_CODECS = {
    **{f'q{n}': (lambda x, n=n: audio_io.qn_encode(x, n),
                 lambda b, s, n=n: audio_io.qn_decode_np(b, s, n))
       for n in audio_io.QN_BITS},
    'mulaw': (audio_io.mulaw_encode, lambda b, s: audio_io.mulaw_decode(b)),
    'adpcm4': (audio_io.adpcm_encode_np, audio_io.adpcm_decode_np),
    **{f'adpcm{n}': (lambda x, n=n: audio_io.adpcm_n_encode_np(x, n),
                     lambda b, s, n=n: audio_io.adpcm_n_decode_np(b, s, n))
       for n in (3, 2)},
}


@pytest.mark.parametrize('name', sorted(ENCODERS))
def test_numpy_codecs_equal_sed_tpu(name):
    """The port's copies of the numpy encoders and reference decoders
    (what chip_smoke.py makes and checks its wires with) give
    ``sed_tpu``'s bytes and samples; ``sed_tpu``'s ADPCM encoders run its
    native codec, bit-exact to the numpy one."""
    x = _signals(64640)
    pcm = (x * 32767).astype(np.int16)
    for inp in (x, pcm):
        buf = PORT_CODECS[name][0](inp)
        assert np.array_equal(buf, ENCODERS[name][0](inp))
        assert np.array_equal(_bits(PORT_CODECS[name][1](buf, 64640)),
                              _bits(ENCODERS[name][1](buf, 64640)))


def _v6_pool(rows, tail_words: int = 2048):
    """sed_tpu's pool layout: payloads back to back, a zero tail, the
    word offsets, and one padding row pointing into the tail."""
    sizes = [r.nbytes for r in rows]
    pool = np.concatenate(list(rows) + [np.zeros(4 * tail_words, np.uint8)])
    offsets = np.concatenate([[0], np.cumsum(sizes)]) // 4
    return pool.view(np.int32), offsets.astype(np.int32)


def _v6_signals(samples: int) -> np.ndarray:
    """``tests/test_v6.py``'s edge inputs (silence, DC, 440 Hz and 7.9 kHz
    tones, uniform noise) and a bench-corpus clip."""
    t = np.arange(samples) / 16000
    return np.stack([
        np.zeros(samples), np.ones(samples),
        0.4 * np.sin(2 * np.pi * 440 * t), 0.9 * np.sin(2 * np.pi * 7900 * t),
        np.random.RandomState(3).uniform(-1, 1, samples),
        make_clips(1, 16000, seconds=5, seed=3)[0][:samples]]
    ).astype(np.float32)


@pytest.mark.parametrize('samples', [80000, 16000])
def test_dequant_v6_pool_bitwise_equal_to_sed_tpu(samples):
    """The port's pool decode on the CPU (the predictor's plain version)
    against sed_tpu's JAX ``dequant_v6_pool`` and ``v6_decode_np`` (and
    so q6's decode), with an int16 clip and a padding row that decodes
    to silence."""
    x = _v6_signals(samples)
    pcm = (np.random.RandomState(4).uniform(-1, 1, samples)
           * 32767).astype(np.int16)
    rows = [audio_io.v6_encode_clip(c) for c in x] + \
        [audio_io.v6_encode_clip(pcm)]
    pool, offsets = _v6_pool(rows)
    got = wire.dequant_v6_pool(torch.from_numpy(pool),
                               torch.from_numpy(offsets), samples)
    assert got.dtype == torch.float32 and got.shape == (len(rows) + 1,
                                                        samples)
    got = got.numpy()
    if samples == 80000:            # one JAX compile is enough
        want = jax_wire.dequant_v6_pool(jnp.asarray(pool),
                                        jnp.asarray(offsets), samples)
        assert np.array_equal(_bits(got), _bits(want))
    for i, row in enumerate(rows):
        assert np.array_equal(_bits(got[i]), _bits(
            jax_audio_io.v6_decode_np(row, samples)))
    q6 = jax_audio_io.qn_decode_np(jax_audio_io.qn_encode(x, 6), samples, 6)
    assert np.array_equal(_bits(got[:len(x)]), _bits(q6))
    assert not _bits(got[-1]).any()          # the padding row: +0.0


def test_v6_predictor_plain_keeps_int32_arithmetic():
    """The recurrence's plain version on hand-made lanes of every order,
    with negative products (the arithmetic right shift) and wrapping
    int32 sums, against a step-by-step numpy int32 evaluation."""
    rng = np.random.RandomState(0)
    lanes = 64
    r = rng.randint(-32, 32, (lanes, 128)).astype(np.int32)
    order = np.arange(lanes, dtype=np.int32) % 4
    coef = rng.randint(-128, 128, lanes).astype(np.int32)
    init1 = rng.randint(-128, 128, lanes).astype(np.int32)
    init2 = rng.randint(-128, 128, lanes).astype(np.int32)
    scale = rng.uniform(0.001, 0.03, lanes).astype(np.float32)
    got = wire._v6_predict(*(torch.from_numpy(a) for a in (
        r, order, coef, init1, init2, scale))).numpy()
    def recurrence(dtype):
        qp, qp2 = init1.astype(dtype), init2.astype(dtype)
        q = np.empty(r.shape, dtype)
        for t in range(128):
            pred = np.select([order == 1, order == 2, order == 3],
                             [qp, 2 * qp - qp2,
                              ((coef * qp + 16) >> 5) - qp2], 0)
            q[:, t] = r[:, t] + pred
            qp2, qp = qp, q[:, t]
        return q

    q = recurrence(np.int32)
    assert np.abs(recurrence(np.int64)).max() > 2 ** 31  # order 3 wraps
    assert np.array_equal(_bits(got), _bits(q.astype(np.float32)
                                            * scale[:, None]))
    assert wire._v6_predict.launches == 0           # the CPU runs plain


@pytest.mark.parametrize('samples', [80000, 96000, 160000])
def test_wire_widths_equal_sed_tpu(samples):
    widths = wire.wire_widths(samples)
    assert widths == jax_wire.wire_widths(samples)
    assert sorted(widths.values(), key=str) == sorted(
        [2, 3, 4, 5, 6, 'adpcm2', 'adpcm3', 'adpcm4'], key=str)


@pytest.mark.parametrize('samples', [257, 259])
def test_wire_widths_asserts_where_sed_tpu_does(samples):
    """At 257 samples the padded adpcm4 width is 257 itself, at 259 the
    adpcm3 width: ``sed_tpu``'s asserts fire there, and the port's too."""
    with pytest.raises(AssertionError):
        jax_wire.wire_widths(samples)
    with pytest.raises(AssertionError):
        wire.wire_widths(samples)


def test_dequant_wire_refuses_what_is_no_wire():
    buf = torch.zeros(2, 80000, dtype=torch.uint8)
    with pytest.raises(ValueError, match='samples'):
        wire.dequant_wire(buf)
    with pytest.raises(ValueError, match='neither'):
        wire.dequant_wire(buf[:, :40000], 80000)
    with pytest.raises(ValueError, match='dtype'):
        wire.dequant_wire(torch.zeros(2, 10, dtype=torch.float64))
    # mu-law at width == samples
    assert wire.dequant_wire(buf, 80000).shape == (2, 80000)


@pytest.fixture(scope='module')
def engines():
    cfg = AUDIO_16K
    ref = jax_engine.SedInferenceEngine(
        jax_get_model(MODEL, cfg), load_variables_npz(CKPT), cfg,
        sample_duration=5, overlap=True, batch_size=8)
    port = engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, 'cpu'), cfg,
                                     'cpu', sample_duration=5, overlap=True,
                                     batch_size=8)
    return ref, port


@pytest.fixture(scope='module')
def clips():
    return make_clips(8, AUDIO_16K.sample_rate, seconds=5, seed=0)


@pytest.mark.parametrize('name', ['adpcm4', 'q6', 'mulaw'])
def test_predict_clips_on_wire_identical_to_sed_tpu(engines, clips, name):
    ref, port = engines
    buf = ENCODERS[name][0](clips)
    ev_ref, xml_ref = ref.predict_clips(buf)
    ev_port, xml_port = port.predict_clips(buf)
    assert sum(map(len, ev_ref)) > 0
    assert ev_port == ev_ref
    assert xml_port == xml_ref
    assert fused_logmel.launches == 0            # the CPU runs plain


@pytest.mark.parametrize('name', ['q2', 'q3', 'q4', 'q5', 'adpcm3',
                                  'adpcm2'])
def test_predict_clips_on_wire_equals_its_decoded_clips(engines, clips,
                                                        name):
    """Every other wire: the engine decodes it on the device into the
    framewise output of the same clips decoded on the host."""
    _, port = engines
    encode, decode_np = ENCODERS[name]
    buf = encode(clips[:4])
    decoded = decode_np(buf, port.window_samples)
    fw, cw = port.infer_framewise(buf)
    fw_dec, cw_dec = port.infer_framewise(decoded)
    assert np.array_equal(fw, fw_dec) and np.array_equal(cw, cw_dec)


def test_predict_clips_rejects_foreign_uint8_widths(engines):
    _, port = engines
    with pytest.raises(ValueError, match='80000'):
        port.predict_clips(np.zeros((2, 30000), np.uint8))
    # an int16 buffer at a wire's width is no wire
    width = jax_audio_io.adpcm_bytes(80000)
    with pytest.raises(ValueError, match='80000'):
        port.predict_clips(np.zeros((2, width), np.int16))


@pytest.fixture(scope='module')
def long_clips():
    return make_clips(3, AUDIO_16K.sample_rate, seconds=7, seed=5)


@pytest.mark.parametrize('name', ['q6', 'adpcm4'])
def test_windowed_on_wire_identical_to_sed_tpu(engines, long_clips, name):
    """``predict_clips_windowed`` takes a wire of the whole clips, as
    ``sed_tpu`` does: ``clip_samples`` names the decoded length, the clip
    is decoded on the device and the windows are cut from it."""
    ref, port = engines
    samples = long_clips.shape[1]
    buf = ENCODERS[name][0](long_clips)
    assert buf.dtype == np.uint8 and buf.shape[1] < samples
    names = ['a', 'b', 'c']
    ev_ref = ref.predict_clips_windowed(buf, names, duration=7.0, step=1,
                                        clip_samples=samples)
    ev_port = port.predict_clips_windowed(buf, names, duration=7.0, step=1,
                                          clip_samples=samples)
    assert sum(map(len, ev_ref)) > 0
    assert ev_port == ev_ref
    # and the wire gives what its decoded clips give
    decoded = ENCODERS[name][1](buf, samples)
    assert port.predict_clips_windowed(decoded, names, duration=7.0,
                                       step=1) == ev_port


def test_windowed_path_refuses_uint8(engines, long_clips):
    """... when ``clip_samples`` is missing: the width of a uint8 buffer
    cannot name its decoded length."""
    _, port = engines
    buf = jax_audio_io.adpcm_encode(long_clips)
    with pytest.raises(ValueError, match='samples'):
        port.predict_clips_windowed(buf, ['a', 'b', 'c'], duration=7.0,
                                    step=1)
