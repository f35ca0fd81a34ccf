"""Time variants of the ADPCM decode kernel on the card (a tuning tool).

    python3 tools/adpcm_variants.py [--runs 8,4] [--variants full,null]

Each variant is ``csrc/adpcm_decode.cu`` with a few lines replaced, built by
``nvcc`` with the package's flags into a temporary directory (all in
parallel) and called through its C entry point on the bench-corpus clips
encoded as adpcm4/3/2, at 32 x 80000 and 256 x 160000, timed as phase 10
of ``chip_smoke.py`` times the kernel (``chip_smoke.queued_ms``).  The
variants that still decode are checked bitwise against
``_adpcm_decode_plain``; the ablations, which leave out a phase of the
kernel, are only timed:

* ``full``: the kernel as it is;
* ``null``: every block returns at once (the launch alone);
* ``empty``: loads, barriers and run walk, no decode and no store;
* ``nodecode`` / ``nostore``: everything but the decode / the stores;
* ``lb4``, ``lb5``, ``lb6``: a launch bound of 4, 5 or 6 blocks an SM.

``--runs`` sets ``kRun``, the ADPCM blocks a CUDA block decodes at once.
Prints one line a variant: registers and spill bytes per width (as ptxas
lists the three instantiations: 2, 3, then 4 bits) and the kernel's µs at
each shape and width.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

_DECODE = '    if (warp < cur.blocks)\n      decode_block'
_STORE = '    store_run(cur, smp, out, tid);'
_BOUND = ('__launch_bounds__(kThreads, kBits == 4 ? 6 : kBits == 3 ? 3 : 4)')
_NEVER = 'cur.n_out < 0'              # false at run time, opaque to nvcc
EDITS = {
    'full': [],
    'null': [('  const int tid = threadIdx.x, lane',
              '  if (runs > 0) return;\n  const int tid = threadIdx.x, lane')],
    'empty': [(_DECODE, _DECODE.replace('blocks)', f'blocks && {_NEVER})')),
              (_STORE, f'    if ({_NEVER}) store_run(cur, smp, out, tid);')],
    'nodecode': [(_DECODE,
                  _DECODE.replace('blocks)', f'blocks && {_NEVER})'))],
    'nostore': [(_STORE,
                 f'    if ({_NEVER}) store_run(cur, smp, out, tid);')],
    **{f'lb{n}': [(_BOUND, f'__launch_bounds__(kThreads, {n})')]
       for n in (4, 5, 6)},
}


def variant_source(src: str, run: int, name: str) -> str:
    out = src.replace('constexpr int kRun = 8;', f'constexpr int kRun = {run};')
    for old, new in EDITS[name]:
        assert out.count(old) == 1, (name, old)
        out = out.replace(old, new)
    return out


def build(src: str, csrc: str, root: str, run: int, name: str):
    """(library path, registers and spill bytes) of one variant."""
    from sed_tpu_torch import _build
    d = os.path.join(root, f'run{run}-{name}')
    os.makedirs(d)
    with open(os.path.join(d, 'adpcm_decode.cu'), 'w') as f:
        f.write(variant_source(src, run, name))
    shutil.copy(os.path.join(csrc, 'bulk_sm90.cuh'), d)
    lib = os.path.join(d, 'lib.so')
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, '-o', lib,
                           os.path.join(d, 'adpcm_decode.cu')],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    log = proc.stdout + proc.stderr
    return lib, (re.findall(r'Used (\d+) registers', log),
                 re.findall(r'(\d+) bytes spill stores', log))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--runs', default='8')
    ap.add_argument('--variants', default='full,null,empty,nodecode,nostore')
    args = ap.parse_args(argv)
    import ctypes

    import numpy as np
    import torch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke
    from sed_tpu_torch import _build
    from sed_tpu_torch.bench_corpus import make_clips
    from sed_tpu_torch.data import audio_io
    from sed_tpu_torch.ops import wire

    if not torch.cuda.is_available():
        raise SystemExit('adpcm_variants: needs a CUDA device')
    print(f'card: {chip_smoke.card_line()}')
    with open(os.path.join(_build.CSRC, 'adpcm_decode.cu')) as f:
        src = f.read()
    todo = [(int(r), v) for r in args.runs.split(',')
            for v in args.variants.split(',')]
    root = tempfile.mkdtemp(prefix='adpcm-variants-')
    try:
        with ThreadPoolExecutor(min(8, len(todo))) as pool:
            libs = list(pool.map(
                lambda rv: build(src, _build.CSRC, root, *rv), todo))
        dev = torch.device('cuda')
        x5 = make_clips(64, 16000, seconds=5, seed=0)
        x10 = x5.reshape(32, 160000)
        cases = []
        for bits in (4, 3, 2):
            def enc(x, bits=bits):
                return (audio_io.adpcm_encode_np(x) if bits == 4
                        else audio_io.adpcm_n_encode_np(x, bits))
            for buf, samples in ((enc(x5)[:32], 80000),
                                 (np.concatenate([enc(x10)] * 8), 160000)):
                wav = torch.from_numpy(buf).to(dev)
                cases.append((bits, wav, samples, wire._adpcm_decode_plain(
                    wav, samples, bits)))
        for (run, name), (path, (regs, spills)) in zip(todo, libs):
            fn = ctypes.CDLL(path).sed_adpcm_decode
            fn.restype = ctypes.c_int
            fn.argtypes = wire._ARGTYPES['adpcm_decode']
            times = []
            for bits, wav, samples, want in cases:
                out = torch.empty((wav.shape[0], samples),
                                  dtype=torch.float32, device=dev)

                def call():
                    rc = fn(wav.data_ptr(), wav.shape[0], wav.shape[1], bits,
                            out.data_ptr(), samples,
                            torch.cuda.current_stream().cuda_stream)
                    assert rc == 0, rc
                call()
                torch.cuda.synchronize()
                if name == 'full' or name.startswith('lb'):
                    assert torch.equal(out.view(torch.int32),
                                       want.view(torch.int32)), (name, bits)
                times.append(chip_smoke.queued_ms(call) * 1e3)
            cells = ' | '.join(f'{b} bits {times[2 * i]:.2f} {times[2 * i + 1]:.1f}'
                               for i, b in enumerate((4, 3, 2)))
            print(f'kRun {run} {name}: registers {regs} spill bytes {spills};'
                  f' us at 32 x 80000 and 256 x 160000: {cells}', flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == '__main__':
    main()
