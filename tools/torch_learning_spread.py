"""The spread of the learning check over initialisations (the PyTorch port).

Trains the bench model of ``tools/torch_make_bench_checkpoint.py`` (its
corpus and flags, 801 iterations through the training CLI's loop) once
for each initialisation named on the command line and prints, for each
run, the best checkpoint's test metrics (the statistic ``chip_smoke.py``
phase 19 gates) and the validation and test trajectory:

* ``sed_tpu``: ``sed_tpu``'s ``PRNGKey(0)`` draw, where its bench run
  began (``compat/flax_init.py``);
* an integer ``s``: the port's own fresh draw from a generator seeded
  ``s`` (``models/blocks.init_weights``; the CLI draws with seed 0).

Usage (on the card):
    python tools/torch_learning_spread.py sed_tpu,sed_tpu,0,1,2 \\
        [extra train flags, e.g. --compute_dtype bf16]
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_make_bench_checkpoint as make_ckpt  # noqa: E402
import torch_synthetic_learning_check as learning  # noqa: E402


def init_flags(init: str, workdir: str) -> list:
    """``--checkpoint`` flags that start a run from ``init``."""
    if init == 'sed_tpu':
        return make_ckpt.train_flags(workdir)
    import numpy as np
    import torch
    from sed_tpu_torch.compat.from_flax import variables_from_model
    from sed_tpu_torch.models.blocks import init_weights
    from sed_tpu_torch.models.registry import get_model
    from sed_tpu_torch.utils.npz_ckpt import save_variables_npz
    model = init_weights(get_model(make_ckpt.MODEL, learning.CFG),
                         torch.Generator().manual_seed(int(init)))
    path = os.path.join(workdir, f'port_init_{init}.npz')
    save_variables_npz(path, variables_from_model(model), dtype=np.float32)
    return ['--stop_iteration', str(make_ckpt.STOP_ITERATION),
            '--checkpoint', path]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    inits, extra = argv[0].split(','), argv[1:]
    corpus = learning.build_corpus(make_ckpt.SIZES)
    for i, init in enumerate(inits):
        with tempfile.TemporaryDirectory() as workdir:
            run = learning.train(corpus, [*init_flags(init, workdir), *extra],
                                 workdir, verbose=False)
        best = run.best('test')
        print(f'run {i} from the {init} initialisation {extra}: best '
              f'iteration {run.best_iteration}, test ER {best["er"]!r} F1 '
              f'{best["f1"]!r} framewise mAP {best["framewise_map"]!r}; '
              f'{run.wall_s:.1f} s', flush=True)
        for e in run.evaluations:
            print('    ' + ' | '.join(
                f'{k} {e["iteration"]}: ER {e[k]["er"]:.4f} F1 '
                f'{e[k]["f1"]:.4f} mAP {e[k]["framewise_map"]:.4f}'
                for k in ('valid', 'test')), flush=True)


if __name__ == '__main__':
    main()
