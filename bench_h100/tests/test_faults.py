"""Each cell's correctness check against a broken timed path, on the CPU
at the rehearsal's tiny size (``rehearse.tiny_cell``).

The harness's look for a card is skipped; the cell's driver runs as in a
real run with the program broken underneath, and ``correct`` must come
out false: for each serving and streaming cell, an answer altered where
it is produced (the forward's framewise output) and the overlap-add's
coverage divisor altered; for the training cell, a step that leaves the
state unchanged and a loss taken over half of each batch.  A sound run
must come out correct.  The cells run on one card, so there is no
exchange between cards to leave out.

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
CELLS = [w['name'] for w in harness.load_json(ROOT, 'BENCHMARK.json')
         ['workloads']]
SERVED = [c for c in CELLS if harness.Cell.load(c).spec['driver']
          in ('serve', 'stream')]
TRAINED = [c for c in CELLS if harness.Cell.load(c).spec['driver'] == 'train']


def correct(name: str) -> bool:
    line, _ = rehearse.run_cell(rehearse.tiny_cell(name), SEED, 1.0, False,
                                log=lambda *a: None)
    return line['correct']


@pytest.mark.parametrize('name', CELLS)
def test_sound_run_is_correct(name):
    assert correct(name)


@pytest.mark.parametrize('name', SERVED)
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


@pytest.mark.parametrize('name', SERVED)
def test_altered_coverage_is_not_correct(name, monkeypatch):
    from sed_tpu_torch.post import merge

    def altered(*args, **kwargs):
        return original(*args, **kwargs) + 1.0
    original = merge.coverage_counts
    monkeypatch.setattr(merge, 'coverage_counts', altered)
    assert not correct(name)


@pytest.mark.parametrize('name', TRAINED)
def test_unchanged_state_is_not_correct(name, monkeypatch):
    from sed_tpu_torch.train import state
    monkeypatch.setattr(state.AmsGrad, 'step', lambda self, closure=None:
                        None)
    assert not correct(name)


@pytest.mark.parametrize('name', TRAINED)
def test_half_batch_is_not_correct(name, monkeypatch):
    from sed_tpu_torch import losses

    def half(loss):
        def f(out, target):
            return loss({k: v[:len(v) // 2] for k, v in out.items()},
                        {k: v[:len(v) // 2] for k, v in target.items()})
        return f
    monkeypatch.setattr(losses, 'clip_bce', half(losses.clip_bce))
    monkeypatch.setattr(losses, 'frame_bce', half(losses.frame_bce))
    assert not correct(name)
