"""The files cell's correctness check against a broken timed path, on the
CPU at the rehearsal's tiny size (``rehearse.tiny_cell``).

The cell's driver (``drivers/files.py``) runs as in a real run with the
program's file reader broken underneath (the reader that
``audio_io.wire_reader_for`` hands the engine), and ``correct`` must
come out false: each row read shifted in time, or read a sample short.
The answer altered where it is produced and the coverage divisor altered
must fail it too, as they do for the serving cells (``test_faults.py``).

    python3 -m pytest bench_h100/tests -q
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_h100 import harness, rehearse  # noqa: E402

SEED = 2 ** 31 + 13
FILED = [w['name'] for w in harness.load_json(ROOT, 'BENCHMARK.json')
         ['workloads']
         if harness.Cell.load(w['name']).spec['driver'] == 'files']


def correct(name: str) -> bool:
    line, _ = rehearse.run_cell(rehearse.tiny_cell(name), SEED, 1.0, False,
                                log=lambda *a: None)
    return line['correct']


def _broken_reader(monkeypatch, fault) -> None:
    from sed_tpu_torch.data import audio_io
    original = audio_io.wire_reader_for

    def wire_reader_for(path):
        reader = original(path)
        return lambda p: fault(np.asarray(reader(p)))
    monkeypatch.setattr(audio_io, 'wire_reader_for', wire_reader_for)


def test_the_files_cell_is_listed():
    assert FILED == ['gru.files.resident']


@pytest.mark.parametrize('name', FILED)
def test_sound_files_are_correct(name):
    assert correct(name)


@pytest.mark.parametrize('name', FILED)
@pytest.mark.parametrize('shift', [160, 8000], ids=['hop', 'half_second'])
def test_shifted_rows_are_not_correct(name, shift, monkeypatch):
    _broken_reader(monkeypatch, lambda row: np.roll(row, shift))
    assert not correct(name)


@pytest.mark.parametrize('name', FILED)
def test_a_header_read_as_samples_is_not_correct(name, monkeypatch):
    # the 44-byte header taken for 22 samples, and the row's end dropped
    def fault(row):
        return np.concatenate([np.full(22, 0x4952, row.dtype), row[:-22]])
    _broken_reader(monkeypatch, fault)
    assert not correct(name)


@pytest.mark.parametrize('name', FILED)
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


@pytest.mark.parametrize('name', FILED)
def test_altered_coverage_is_not_correct(name, monkeypatch):
    from sed_tpu_torch.post import merge

    def altered(*args, **kwargs):
        return original(*args, **kwargs) + 1.0
    original = merge.coverage_counts
    monkeypatch.setattr(merge, 'coverage_counts', altered)
    assert not correct(name)


def test_files_read_back_as_written_and_go_on_close():
    from bench_h100.drivers import files
    from sed_tpu_torch.data import audio_io
    rng = np.random.default_rng(SEED)
    pcm = rng.integers(-32768, 32768, (3, 1601), dtype=np.int16)
    written = files.Files(pcm, 32000)
    paths = list(written.paths)
    reader = audio_io.wire_reader_for(paths[0])
    for path, row in zip(paths, pcm):
        got, sr = audio_io.fast_read_wav_int16(path)
        assert sr == 32000
        np.testing.assert_array_equal(reader(path), row)
        np.testing.assert_array_equal(got, row)
    written.close()
    assert written.paths == []
    for path in paths:
        assert not os.path.exists(path)
