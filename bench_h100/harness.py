"""The benchmark's harness: finds a cell's pieces by name, runs its
driver, reads its per-layer metrics and prints the result line.

A cell ``<cell>`` is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json`` with its plain reference ``configs/<config>.py``),
its traffic (``traffic/<traffic>.json``), its driver
(``drivers/<driver>.py``), the weights it serves, and the limit of each
number its correctness check compares.  A per-layer metric ``<metric>``
is ``metrics/<metric>.py``, whose ``read(run)`` returns a number, or None
where the run has nothing for it to read.  Which metrics a cell reports
is ``BENCHMARK.json``'s: every end-to-end metric and every per-layer
metric whose ``workloads`` name the cell or that names none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'sed_tpu')


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_no_reference_package() -> None:
    """Nothing the benchmark runs may import JAX or the JAX package."""
    bad = sorted(m for m in sys.modules
                 if m.split('.')[0] in FORBIDDEN)
    if bad:
        raise RuntimeError(f'imported {bad}: the benchmark runs the port '
                           'alone')


@dataclasses.dataclass
class Cell:
    """A cell's pieces, found by name."""
    name: str
    spec: dict          # workloads/<name>.json
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    reference: Any      # configs/<config>.py
    driver: Any         # drivers/<driver>.py

    @classmethod
    def load(cls, name: str) -> 'Cell':
        spec = load_json(HERE, 'workloads', f'{name}.json')
        config = load_json(HERE, 'configs', f'{spec["config"]}.json')
        return cls(
            name, spec, config,
            load_json(HERE, 'traffic', f'{spec["traffic"]}.json'),
            load_module(os.path.join(HERE, 'configs',
                                     f'{spec["config"]}.py'),
                        f'bench_config_{len(sys.modules)}'),
            load_module(os.path.join(HERE, 'drivers',
                                     f'{spec["driver"]}.py'),
                        f'bench_driver_{len(sys.modules)}'))


@dataclasses.dataclass
class Run:
    """What a driver hands back.  ``end_to_end``: the cell's end-to-end
    readings; ``checks``: [(name, value, limit)] of the correctness
    check (each value must not exceed its limit); ``trace``: the
    ``trace.Trace`` of the traced segment (``--trace 1``); ``counters``
    and ``info``: what the per-layer readers take besides."""
    attempted: int
    failed: int
    end_to_end: dict
    checks: list
    memory_peak_bytes: Optional[int]
    trace: Any = None
    counters: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    """What a driver is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any                 # torch.device
    t_start: float              # perf_counter at process start
    log: Any = None             # print-like, to standard error

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind]
            if 'workloads' not in m or cell in m['workloads']]


def result_line(bench: dict, cell: Cell, run: Run, trace: bool,
                device: dict, on_card: bool) -> dict:
    """The last line's object.  Off the card no reading is a device
    metric: every value is null."""
    metrics = {}
    if trace:
        for m in cell_metrics(bench, cell.name, 'per_layer'):
            reader = load_module(os.path.join(HERE, 'metrics',
                                              f'{m["name"]}.py'),
                                 f'bench_metric_{len(sys.modules)}')
            value = reader.read(run)
            if value is not None:
                metrics[m['name']] = {'value': float(value) if on_card
                                      else None, 'unit': m['unit']}
    else:
        for m in cell_metrics(bench, cell.name, 'end_to_end'):
            metrics[m['name']] = {
                'value': float(run.end_to_end[m['name']]) if on_card
                else None, 'unit': m['unit']}
    checks = {name: {'value': value, 'limit': limit}
              for name, value, limit in run.checks}
    correct = (run.failed == 0 and bool(run.checks)
               and all(value <= limit for _, value, limit in run.checks))
    line = {'correct': correct, 'attempted': run.attempted,
            'failed': run.failed, 'metrics': metrics, 'device': device}
    if trace and run.trace is not None and on_card:
        line['breakdown'] = run.trace.breakdown()
    line['checks'] = checks
    return line
