"""The wire cells' correctness check against a broken timed path, on the
CPU at the rehearsal's tiny size (``rehearse.tiny_cell``), and the
per-layer readers this set of cells added, on stand-in runs.

The wire cells' driver (``drivers/wire.py``) runs as in a real run with
the program's wire decode broken underneath (``ops/wire._adpcm_decode``,
which ``dequant_wire`` calls for an ADPCM row on any device), and
``correct`` must come out false: samples off by a gain, one ADPCM
block's samples lost, and the codes read high nibble first.  The answer
altered where it is produced and the coverage divisor altered must fail
it too, as they do for the other serving cells (``test_faults.py``).

    python3 -m pytest bench_h100/tests -q
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_h100 import harness, rehearse, yardstick  # noqa: E402

SEED = 2 ** 31 + 7
WIRED = [w['name'] for w in harness.load_json(ROOT, 'BENCHMARK.json')
         ['workloads']
         if harness.Cell.load(w['name']).spec['driver'] == 'wire']


def correct(name: str) -> bool:
    line, _ = rehearse.run_cell(rehearse.tiny_cell(name), SEED, 1.0, False,
                                log=lambda *a: None)
    return line['correct']


def _halved(decode, wav, *args):
    return decode(wav, *args) * 0.5


def _block_lost(decode, wav, *args):
    x = decode(wav, *args).clone()
    x[:, 505:1010] = 0.0
    return x


def _nibbles_swapped(decode, wav, *args):
    return decode(((wav & 15) << 4) | (wav >> 4), *args)


@pytest.mark.parametrize('name', WIRED)
@pytest.mark.parametrize('fault', [_halved, _block_lost, _nibbles_swapped],
                         ids=['gain', 'block', 'nibbles'])
def test_corrupted_decode_is_not_correct(name, fault, monkeypatch):
    from sed_tpu_torch.ops import wire

    def corrupted(wav, *args, **kwargs):
        return fault(lambda *a: original(*a, **kwargs), wav, *args)
    original = wire._adpcm_decode
    monkeypatch.setattr(wire, '_adpcm_decode', corrupted)
    assert not correct(name)


@pytest.mark.parametrize('name', WIRED)
def test_altered_answer_is_not_correct(name, monkeypatch):
    from sed_tpu_torch.serve import engine

    def altered(self, model, rows):
        framewise, clipwise = original(self, model, rows)
        framewise = framewise.clone()
        framewise[..., 0] = 1.0 - framewise[..., 0]
        return framewise, clipwise
    original = engine.SedInferenceEngine._run
    monkeypatch.setattr(engine.SedInferenceEngine, '_run', altered)
    assert not correct(name)


@pytest.mark.parametrize('name', WIRED)
def test_altered_coverage_is_not_correct(name, monkeypatch):
    from sed_tpu_torch.post import merge

    def altered(*args, **kwargs):
        return original(*args, **kwargs) + 1.0
    original = merge.coverage_counts
    monkeypatch.setattr(merge, 'coverage_counts', altered)
    assert not correct(name)


def test_wire_reaches_the_program_encoded(monkeypatch):
    """The program is sent the uint8 rows, and its own decode of them is
    the plain decoder's."""
    from sed_tpu_torch.ops import wire
    sent = []

    def seen(wav, *args, **kwargs):
        sent.append((wav.dtype, tuple(wav.shape)))
        return original(wav, *args, **kwargs)
    original = wire.dequant_wire
    monkeypatch.setattr(wire, 'dequant_wire', seen)
    assert correct(WIRED[0])
    assert sent and all(d == torch.uint8 and w % 256 == 1
                        for d, (_, w) in sent), sent[:3]


# ---------------------------------------------------------------------------
# the readers, on stand-in runs
# ---------------------------------------------------------------------------

def _reader(name):
    return harness.load_module(
        os.path.join(ROOT, 'bench_h100', 'metrics', f'{name}.py'),
        f'test_wire_metric_{name}')


def _trace(spans=(), kernels=None, device_us=None):
    """A stand-in for ``trace.Trace``: host spans (name, start, end) on
    measuring thread 1, kernels {name: (us, launches)}, and the device
    time under each span name."""
    host = [types.SimpleNamespace(name=n, thread=1,
                                  time_range=types.SimpleNamespace(
                                      start=s, end=e))
            for n, s, e in spans]
    kernels = kernels or {}

    def kernel_us(part):
        hits = [v for k, v in kernels.items() if part in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)
    return types.SimpleNamespace(
        host=host, thread=1, kernel_us=kernel_us,
        span_us=lambda name: (device_us or {}).get(name, 0.0))


def test_tile_use_reads_the_programs_counters(monkeypatch):
    from sed_tpu_torch.ops.conv3x3 import conv3x3
    reader = _reader('conv3x3_tile_use.serve')
    serve = types.SimpleNamespace(info={'kind': 'serve'})
    monkeypatch.setattr(conv3x3, 'flop', 3, raising=False)
    monkeypatch.setattr(conv3x3, 'tile_flop', 4, raising=False)
    assert reader.read(serve) == 75.0
    assert reader.read(types.SimpleNamespace(info={'kind': 'train'})) \
        is None
    monkeypatch.setattr(conv3x3, 'tile_flop', 0, raising=False)
    assert reader.read(serve) is None
    # a program without the counters
    monkeypatch.delattr(conv3x3, 'flop', raising=False)
    monkeypatch.delattr(conv3x3, 'tile_flop', raising=False)
    assert reader.read(serve) is None


def test_panns_head_reader():
    reader = _reader('panns_head_ms_per_clip.serve')
    info = {'kind': 'serve', 'traced_clips': 64}
    trace = _trace([('sed::panns.head', 0, 10), ('sed::panns.head', 20, 30)],
                   device_us={'sed::panns.head': 320.0})
    assert reader.read(types.SimpleNamespace(trace=trace, info=info)) == \
        pytest.approx(320 / 1e3 / 64, rel=1e-12)
    # another model, a program without the span, another kind of run
    bare = _trace([('sed::conv.3x3', 0, 10)],
                  device_us={'sed::conv.3x3': 5.0})
    assert reader.read(types.SimpleNamespace(trace=bare, info=info)) is None
    assert reader.read(types.SimpleNamespace(
        trace=trace, info=dict(info, kind='eval'))) is None
    assert reader.read(types.SimpleNamespace(trace=None, info=info)) is None


def test_adpcm_roofline_reader():
    from sed_tpu_torch.data import audio_io
    reader = _reader('adpcm_roofline.serve')
    width = audio_io.adpcm_bytes(80000)
    info = {'kind': 'serve', 'wire': 'adpcm4', 'traced_clips': 1024,
            'clip_samples': 80000, 'wire_bytes': width}
    # 32 launches of 32 rows, 9 us each
    trace = _trace(kernels={'void adpcm_decode_kernel<4>(...)':
                            (32 * 9.0, 32)})
    run = types.SimpleNamespace(trace=trace, info=info,
                                counters={'_adpcm_decode.launches': 32})
    bound_s = 32 * (width + 4 * 80000) / yardstick.PEAK_HBM_BYTES
    assert bound_s == pytest.approx(3.445e-6, rel=1e-3)   # 11.54 MB
    assert reader.read(run) == pytest.approx(100 * bound_s / 9e-6,
                                             rel=1e-12)
    lost = types.SimpleNamespace(trace=trace, info=info,
                                 counters={'_adpcm_decode.launches': 33})
    with pytest.raises(RuntimeError, match='ADPCM launches'):
        reader.read(lost)
    # an int16 serving cell, a segment without the kernel
    assert reader.read(types.SimpleNamespace(
        trace=trace, info=dict(info, wire=None), counters={})) is None
    assert reader.read(types.SimpleNamespace(
        trace=_trace(), info=info, counters={})) is None


def test_plain_decoder_is_the_programs():
    from bench_h100.reference import adpcm
    from sed_tpu_torch.data import audio_io
    rng = np.random.RandomState(4)
    pcm = (rng.standard_normal((3, 2000)) * 3000).astype(np.int16)
    rows = audio_io.adpcm_encode_np(pcm)
    assert np.array_equal(adpcm.decode(rows, 2000),
                          audio_io.adpcm_decode_np(rows, 2000))
