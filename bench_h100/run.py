"""Run one benchmark cell of the PyTorch port on the card.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's model and traffic, warms up every shape the traffic
uses, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output (``--trace 1``: the per-layer metrics, read from a
traced segment after the window).  Exits non-zero, printing no result,
without as many CUDA devices as the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build', 'bench_h100',
                                                  'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'bench_h100',
                                              'triton')
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def card_info(torch, count: int) -> dict:
    import subprocess
    limit = None
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader,nounits'],
                             capture_output=True, text=True, timeout=30)
        limit = float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': count, 'power_limit_w': limit}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from bench_h100 import harness
    harness.assert_no_reference_package()
    bench = harness.load_json(ROOT, 'BENCHMARK.json')
    cell = harness.Cell.load(args.workload)
    chips = cell.spec['chips']

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f'{args.workload} needs {chips} CUDA device(s); '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
            ' available')
        return 2
    device = torch.device('cuda:0')
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace),
                          device, T_START, log)
    run = cell.driver.run(ctx)
    info = card_info(torch, chips)
    info['memory_peak_bytes'] = run.memory_peak_bytes
    if args.trace and run.trace is not None:
        info['busy_s'] = run.trace.busy_us / 1e6
        info['window_s'] = run.trace.window_us / 1e6
    line = harness.result_line(bench, cell, run, bool(args.trace), info,
                               on_card=True)
    harness.assert_no_reference_package()
    log(f'{args.workload} seed {args.seed}: {info["kind"]}, power limit '
        f'{info["power_limit_w"]} W')
    for name, c in line['checks'].items():
        log(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})')
    import json
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
