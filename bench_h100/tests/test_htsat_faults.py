"""The HTS-AT cell's correctness check against a broken timed path, on
the CPU at the rehearsal's tiny size (``rehearse.tiny_cell``), and the
per-layer readers it added, on stand-in runs.

The cell's driver (``drivers/windowed.py``) runs as in a real run with
the model's windows altered where HTS-AT produces them, and ``correct``
must come out false (``test_windowed_faults.py`` alters ``CnnSed``'s
windows, which this model is not).  Each reader returns None without its
span.

    python3 -m pytest bench_h100/tests -q
"""

import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_h100 import harness, rehearse, yardstick  # noqa: E402

SEED = 2 ** 31 + 9
CELL = 'htsat.eval.10s'


def correct() -> bool:
    line, _ = rehearse.run_cell(rehearse.tiny_cell(CELL), SEED, 1.0, False,
                                log=lambda *a: None)
    return line['correct']


def test_altered_htsat_output_is_not_correct(monkeypatch):
    """HTS-AT's windows altered as the model produces them: the check
    fails; the same run with the model as it is passes."""
    from sed_tpu_torch.models import htsat

    def altered(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        framewise = out['framewise_output'].clone()
        framewise[..., 0] = 1.0 - framewise[..., 0]
        return dict(out, framewise_output=framewise)
    original = htsat.HtsatSed.forward
    monkeypatch.setattr(htsat.HtsatSed, 'forward', altered)
    assert not correct()
    monkeypatch.setattr(htsat.HtsatSed, 'forward', original)
    assert correct()


# ---------------------------------------------------------------------------
# the HTS-AT cell's readers, on stand-in runs
# ---------------------------------------------------------------------------

def _reader(name):
    return harness.load_module(
        os.path.join(ROOT, 'bench_h100', 'metrics', f'{name}.py'),
        f'test_htsat_metric_{name}')


def _trace(spans=(), device_us=None, gaps=()):
    """A stand-in for ``trace.Trace``: host spans (name, start, end) on
    measuring thread 1, the device time under each span name, and the
    segment's idle gaps."""
    host = [types.SimpleNamespace(name=n, thread=1,
                                  time_range=types.SimpleNamespace(
                                      start=s, end=e))
            for n, s, e in spans]
    return types.SimpleNamespace(
        host=host, thread=1, idle_gaps=lambda: list(gaps),
        span_us=lambda name: (device_us or {}).get(name, 0.0))


def _info(cell):
    return {'kind': 'eval', 'config': cell.config, 'model': cell.reference,
            'traced_clips': 64, 'clips': 640, 'windows': 640}


def test_swin_roofline_reader():
    cell = harness.Cell.load(CELL)
    reader = _reader('swin_roofline.eval')
    spans = [('sed::htsat.encoder', 0, 10), ('sed::htsat.encoder', 20, 30)]
    trace = _trace(spans, {'sed::htsat.encoder': 20000.0})
    run = types.SimpleNamespace(trace=trace, info=_info(cell))
    flop = 64 * cell.reference.encoder_flop(cell.config)
    nbytes = 2 * cell.reference.encoder_bytes(cell.config, 32)
    assert flop / yardstick.PEAK_FP32_FLOPS > \
        nbytes / yardstick.PEAK_HBM_BYTES
    assert reader.read(run) == pytest.approx(
        100 * flop / yardstick.PEAK_FP32_FLOPS / 0.02, rel=1e-12)
    # 11.8 GFLOP a window: 64 windows in 20 ms is 56% of 67 TFLOP/s
    assert 55 < reader.read(run) < 57
    # another model, a program without the span, another kind of run
    bare = _trace([('sed::conformer.encoder', 0, 10)],
                  {'sed::conformer.encoder': 5.0})
    assert reader.read(types.SimpleNamespace(trace=bare,
                                             info=_info(cell))) is None
    assert reader.read(types.SimpleNamespace(
        trace=trace, info=dict(_info(cell), kind='serve'))) is None
    assert reader.read(types.SimpleNamespace(trace=None,
                                             info=_info(cell))) is None


def test_window_attention_reader():
    cell = harness.Cell.load(CELL)
    reader = _reader('window_attn_ms_per_clip.eval')
    trace = _trace([('sed::htsat.attn', 0, 1), ('sed::htsat.attn', 2, 3)],
                   {'sed::htsat.attn': 640.0})
    assert reader.read(types.SimpleNamespace(trace=trace, info=_info(cell))) \
        == pytest.approx(640 / 1e3 / 64, rel=1e-12)
    bare = _trace([('sed::htsat.encoder', 0, 10)],
                  {'sed::htsat.encoder': 5.0})
    assert reader.read(types.SimpleNamespace(trace=bare,
                                             info=_info(cell))) is None
    assert reader.read(types.SimpleNamespace(
        trace=trace, info=dict(_info(cell), kind='serve'))) is None


def test_swin_idle_reader():
    cell = harness.Cell.load(CELL)
    reader = _reader('swin_idle_ms_per_clip.eval')
    # idle 5-8 and 25-40: the spans 0-10 and 20-30 cover 3 + 5 us of it
    trace = _trace([('sed::htsat.encoder', 0, 10),
                    ('sed::htsat.encoder', 20, 30)], gaps=[(5, 8), (25, 40)])
    assert reader.read(types.SimpleNamespace(trace=trace, info=_info(cell))) \
        == pytest.approx(8 / 1e3 / 64, rel=1e-12)
    bare = _trace([('sed::serve.decode', 0, 10)], gaps=[(0, 10)])
    assert reader.read(types.SimpleNamespace(trace=bare,
                                             info=_info(cell))) is None
