"""Each cell's control at the rehearsal's tiny size on the CPU: the plain
reference in bfloat16 in the program's place must fail at least one of
the cell's limits, and the program's own run must pass them all.  The
same readings at the cells' own sizes come from ``control.py`` on the
card, where the limits were set.

    python3 -m pytest bench_h100/tests -q
"""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_h100 import harness, rehearse  # noqa: E402

CELLS = [w['name'] for w in harness.load_json(ROOT, 'BENCHMARK.json')
         ['workloads']]


@pytest.mark.parametrize('name', CELLS)
def test_control_fails_and_program_passes(name):
    import torch
    cell = rehearse.tiny_cell(name)
    ctx = harness.Context(cell, 2 ** 31 + 9, 0.0, False, torch.device('cpu'),
                          time.perf_counter(), lambda *a: None)
    got = cell.driver.control(ctx)
    limits = cell.spec['limits']
    program = {k.split('.', 1)[1] if k.startswith('program.') else
               'framewise_err': v for k, v in got.items()
               if k.startswith('program')}
    control = {k.split('.', 1)[1] if k.startswith('control.') else
               'framewise_err': v for k, v in got.items()
               if k.startswith('control')}
    assert all(program[k] <= limits[k] for k in limits), (program, limits)
    assert any(control[k] > limits[k] for k in control if k in limits), \
        (control, limits)
