"""Rehearse every cell of ``BENCHMARK.json`` on the CPU, at a tiny size.

    python3 bench_h100/rehearse.py [--cells a,b] [--trace 0,1]

Each cell's driver runs with a narrow model (conv channels 8/16/16/32,
GRU 16), seeded weights, a few clips, a window of ``--seconds`` and the
program's plain kernels (the CPU path of ``fused_logmel``), through the
same harness as ``run.py``; its result line must have the contract's
shape, every metric of the cell present and null (no device metric is
printed without a card), and ``correct`` true.  Then, at full width on
the CPU: the benchmark's checkpoint mapping against the program's own
loader, and the plain reference's forward against the program's.
Asserts that neither JAX nor the JAX package was imported.  Never used
for numbers.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = {'conv_channels': [8, 16, 16, 32], 'gru_hidden': 16}
TINY_TRAFFIC = {
    'closed_loop_clips': {'pool_clips': 8, 'request_clips': 4,
                          'batch_size': 2, 'warm_requests': 1,
                          'traced_requests': 2, 'checked_requests': 2,
                          'checked_within': 8},
    'train_steps': {'weak_pool': 8, 'strong_pool': 4, 'weak_batch': 4,
                    'strong_batch': 2, 'clip_seconds': 2, 'traced_steps': 1},
    'live_streams': {'pool_clips': 12, 'clips_per_stream': 2,
                     'streams': 3, 'checked_streams': 1,
                     'checked_within': 2},
}


def tiny_cell(name: str):
    from bench_h100 import harness
    cell = harness.Cell.load(name)
    cell.config = dict(copy.deepcopy(cell.config), **TINY_MODEL)
    if 'd_model' in cell.config:
        cell.config['d_model'] = TINY_MODEL['conv_channels'][-1]
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[cell.traffic['kind']])
    cell.spec = dict(cell.spec, weights='seeded')
    return cell


def run_cell(cell, seed: int, seconds: float, trace: bool, log=None):
    """The cell's driver through the harness, off the card: the result
    line and the driver's ``Run``."""
    import torch
    from bench_h100 import harness
    bench = harness.load_json(ROOT, 'BENCHMARK.json')
    ctx = harness.Context(cell, seed, seconds, trace, torch.device('cpu'),
                          time.perf_counter(),
                          log or (lambda *a: print(*a, file=sys.stderr)))
    run = cell.driver.run(ctx)
    info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': None}
    return harness.result_line(bench, cell, run, trace, info,
                               on_card=False), run


def check_line(name: str, line: dict, trace: bool) -> None:
    from bench_h100 import harness
    bench = harness.load_json(ROOT, 'BENCHMARK.json')
    keys = list(line)
    assert keys[:5] == ['correct', 'attempted', 'failed', 'metrics',
                        'device'] and keys[-1] == 'checks', keys
    kind = 'per_layer' if trace else 'end_to_end'
    want = {m['name'] for m in harness.cell_metrics(bench, name, kind)}
    got = set(line['metrics'])
    if not trace:
        assert got == want, (name, got, want)
    assert got <= want, (name, got - want)
    assert all(m['value'] is None for m in line['metrics'].values()), \
        f'{name}: a device metric printed off the card'
    assert line['correct'], (name, line)
    json.dumps(line)


def full_width_checks() -> None:
    """The checkpoint mapping and the plain reference at full width."""
    import numpy as np
    import torch
    from bench_h100 import common, harness
    from sed_tpu_torch.compat.from_flax import load_npz
    cell = harness.Cell.load('gru.serve.5s')
    cfg = common.program_audio(cell.config)
    mine = cell.reference.weights(cell.config, 0, 'cpu', 'checkpoint')
    theirs = load_npz(os.path.join(ROOT, 'tools', 'bench_checkpoint.npz'),
                      cell.config['model_type'], cfg, 'cpu').state_dict()
    for k, v in mine.items():
        assert torch.equal(v, theirs[k].float()), k
    assert set(theirs) - set(mine) <= {k for k in theirs
                                       if 'num_batches' in k}
    from bench_h100 import generate
    clips, _ = generate.make_clips(2, 16000, 5, 3, cell.config['classes'])
    wav = torch.from_numpy(clips)
    for name in ('gru.serve.5s', 'transformer.serve.5s'):
        c = harness.Cell.load(name)
        tensors = c.reference.weights(c.config, 5, 'cpu', 'checkpoint')
        model = c.reference.program_model(c.config, tensors, cfg, 'cpu')
        with torch.no_grad():
            want = model(wav)['framewise_output']
            got, _ = c.reference.reference(tensors, wav, c.config)
        err = (got - want).abs().max().item()
        print(f'{name}: full width on the CPU, |reference - program| '
              f'framewise {err:.3g} over {tuple(got.shape)}',
              file=sys.stderr)
        assert got.shape == want.shape and err < 1e-4, err


def main(argv=None) -> int:
    from bench_h100 import harness
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--cells', default='')
    p.add_argument('--trace', default='0,1')
    p.add_argument('--seconds', type=float, default=2.0)
    p.add_argument('--skip-full-width', action='store_true')
    args = p.parse_args(argv)
    harness.assert_no_reference_package()
    bench = harness.load_json(ROOT, 'BENCHMARK.json')
    names = args.cells.split(',') if args.cells else [
        w['name'] for w in bench['workloads']]
    for name in names:
        for trace in (bool(int(t)) for t in args.trace.split(',')):
            line, _ = run_cell(tiny_cell(name), 2 ** 31 + 11, args.seconds,
                               trace)
            check_line(name, line, trace)
            print(f'{name} --trace {int(trace)}: line ok, checks '
                  f'{line["checks"]}, attempted {line["attempted"]}',
                  file=sys.stderr)
    if not args.skip_full_width:
        full_width_checks()
    harness.assert_no_reference_package()
    print('rehearsal passed', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
