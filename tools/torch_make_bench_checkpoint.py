"""Train the bench model with the PyTorch port and export it as a ``.npz``
(counterpart of ``tools/make_bench_checkpoint.py``).

Builds the 96/96/24/24-clip corpus of ``tools/make_bench_checkpoint.py``
in memory (``tools/torch_synthetic_learning_check.py``), trains
``Cnn_9layers_Gru_FrameAtt`` with the same flags through the training
CLI's loop for 801 iterations, and writes the best checkpoint (by
validation framewise mAP and ER) with ``utils/npz_ckpt.save_variables_npz``
(float16 leaves, flax keys): ``sed_tpu`` and the port both read it.

The run starts from ``sed_tpu``'s own fresh initialisation, the
``PRNGKey(0)`` draw its trainer starts from
(``compat/flax_init.gru_frameatt_variables``, passed by ``--checkpoint``),
so that it and ``sed_tpu``'s run differ only in the steps' random draws
and arithmetic; ``--checkpoint PATH`` among the extra flags starts from
another ``.npz`` or ``.pth``.

Usage: python tools/torch_make_bench_checkpoint.py [--out PATH]
           [--workdir DIR] [--device cpu] [extra train flags...]

The output is never ``tools/bench_checkpoint.npz`` (``sed_tpu``'s trained
checkpoint, the oracle of the serving tests); it defaults to
``build/sed_tpu_torch/bench_checkpoint_torch.npz``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_synthetic_learning_check as learning  # noqa: E402

from sed_tpu_torch._build import BUILD_DIR  # noqa: E402

MODEL = 'Cnn_9layers_Gru_FrameAtt'
SIZES = {'weak_training': 96, 'strong_training': 96,
         'strong_validation': 24, 'testing': 24}
STOP_ITERATION = 801
OUT = os.path.join(BUILD_DIR, 'bench_checkpoint_torch.npz')
ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'bench_checkpoint.npz')


def sed_tpu_init(path: str) -> str:
    """Write ``sed_tpu``'s fresh initialisation of the bench model (its
    trainer's ``PRNGKey(0)`` draw) to ``path`` as a float32 ``.npz``."""
    import numpy as np
    from sed_tpu_torch.compat.flax_init import gru_frameatt_variables
    from sed_tpu_torch.compat.from_flax import variables_from_model
    from sed_tpu_torch.models.registry import get_model
    from sed_tpu_torch.utils.npz_ckpt import save_variables_npz
    template = variables_from_model(get_model(MODEL, learning.CFG))
    save_variables_npz(path, gru_frameatt_variables(template, seed=0),
                       dtype=np.float32)
    return path


def train_flags(workdir: str) -> list:
    """The run's flags beside ``TRAIN_FLAGS``: 801 iterations from
    ``sed_tpu``'s initialisation, written into ``workdir``."""
    return ['--stop_iteration', str(STOP_ITERATION), '--checkpoint',
            sed_tpu_init(os.path.join(workdir, 'sed_tpu_init.npz'))]


def export(run: learning.Run, out: str) -> str:
    """Write ``run``'s best checkpoint to ``out`` as a ``.npz``."""
    from sed_tpu_torch.compat.from_flax import (load_checkpoint,
                                                variables_from_model)
    from sed_tpu_torch.utils.npz_ckpt import save_variables_npz
    if os.path.abspath(out) == os.path.abspath(ORACLE):
        raise SystemExit(f'{out} is sed_tpu\'s trained checkpoint, the '
                         'oracle of the serving tests: write elsewhere')
    model = load_checkpoint(run.best_checkpoint, run.args.model_type,
                            learning.CFG, 'cpu',
                            feature_type=run.args.feature_type)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_variables_npz(out, variables_from_model(model))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', default=OUT)
    parser.add_argument('--workdir', default=None)
    args, extra = parser.parse_known_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix='sed_torch_bench_')
    os.makedirs(workdir, exist_ok=True)
    corpus = learning.build_corpus(SIZES)
    print(f'corpus of {sum(SIZES.values())} clips of 10 s built in memory '
          f'in {corpus.seconds:.1f} s', flush=True)
    run = learning.train(corpus, [*train_flags(workdir), *extra], workdir)
    out = export(run, args.out)
    print(f'wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB) from '
          f'iteration {run.best_iteration}')
    return run, out


if __name__ == '__main__':
    main()
