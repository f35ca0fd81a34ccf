"""The readings that set each correctness limit, on the card, at a
cell's own size: for each seed, the program's sound reading and the
control's (the plain reference in the next lower precision in the
program's place), as the cell's driver defines them (``control(ctx)``).

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed and a summary: the largest sound reading
and the smallest control reading.  The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build', 'bench_h100',
                                                  'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'bench_h100',
                                              'triton')
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    args = p.parse_args(argv)
    import torch
    from bench_h100 import harness
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    cell = harness.Cell.load(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(',')):
        ctx = harness.Context(cell, seed, 0.0, False, torch.device('cuda:0'),
                              time.perf_counter(),
                              lambda *a: print(*a, file=sys.stderr))
        t0 = time.perf_counter()
        row = dict(seed=seed, **cell.driver.control(ctx))
        row['seconds'] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    harness.assert_no_reference_package()
    summary = {'workload': args.workload, 'seeds': len(rows),
               'card': torch.cuda.get_device_name(0)}
    for key in rows[0]:
        if key not in ('seed', 'seconds') and \
                isinstance(rows[0][key], (int, float)):
            vals = [r[key] for r in rows]
            summary[key] = [min(vals), max(vals)]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
