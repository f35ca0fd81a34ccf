"""The windowed evaluation cells' correctness check against a broken timed
path, on the CPU at the rehearsal's tiny size (``rehearse.tiny_cell``).

``test_faults.py`` breaks the serving and streaming paths where they
produce their answer (``SedInferenceEngine._run``), which the windowed
path does not call.  Here the cell's driver runs as in a real run with
``predict_clips_windowed`` broken underneath, and ``correct`` must come
out false: an answer altered in the windows' framewise output as the
model produces it, an answer altered in the merged tracks handed to the
decode (halved), and the merge's coverage divisor altered.

    python3 -m pytest bench_h100/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_h100 import harness, rehearse  # noqa: E402

SEED = 2 ** 31 + 5
WINDOWED = [w['name'] for w in harness.load_json(ROOT, 'BENCHMARK.json')
            ['workloads']
            if harness.Cell.load(w['name']).spec['driver'] == 'windowed']


def correct(name: str) -> bool:
    line, _ = rehearse.run_cell(rehearse.tiny_cell(name), SEED, 1.0, False,
                                log=lambda *a: None)
    return line['correct']


def _flip(framewise):
    framewise = framewise.clone()
    framewise[..., 0] = 1.0 - framewise[..., 0]
    return framewise


@pytest.mark.parametrize('name', WINDOWED)
def test_altered_window_output_is_not_correct(name, monkeypatch):
    from sed_tpu_torch.models import zoo

    def altered(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        return dict(out, framewise_output=_flip(out['framewise_output']))
    original = zoo.CnnSed.forward
    monkeypatch.setattr(zoo.CnnSed, 'forward', altered)
    assert not correct(name)


@pytest.mark.parametrize('name', WINDOWED)
def test_altered_merged_answer_is_not_correct(name, monkeypatch):
    from sed_tpu_torch.serve import engine

    # halved, every track's events go: the tiny model's flat tracks keep
    # their whole-clip events under ``_flip``
    def altered(self, framewise, names):
        return original(self, framewise * 0.5, names)
    original = engine.SedInferenceEngine._events_on_device
    monkeypatch.setattr(engine.SedInferenceEngine, '_events_on_device',
                        altered)
    assert not correct(name)


@pytest.mark.parametrize('name', WINDOWED)
def test_altered_merge_coverage_is_not_correct(name, monkeypatch):
    from sed_tpu_torch.post import merge

    def altered(*args, **kwargs):
        return original(*args, **kwargs) + 1.0
    original = merge.coverage_counts
    monkeypatch.setattr(merge, 'coverage_counts', altered)
    assert not correct(name)
