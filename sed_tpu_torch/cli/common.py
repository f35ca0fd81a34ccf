"""Shared CLI plumbing of the port: model loading (counterpart of
``sed_tpu/cli/common.py:build_model_and_variables``).

Flags, workspace paths and threshold pickles are ``sed_tpu``'s own
(``sed_tpu_torch._host.cli_common``).
"""

from __future__ import annotations

import os


def add_model_args(parser) -> None:
    """``--checkpoint`` and the required ``--device``."""
    parser.add_argument('--checkpoint', type=str, default=None,
                        help='sed_tpu .npz or reference .pth checkpoint '
                             '(default: the workspace .pth)')
    parser.add_argument('--device', type=str, required=True,
                        help="torch device to run on, e.g. 'cuda' or 'cpu'")


def checkpoint_path(args, cfg, ws) -> str:
    """``--checkpoint``, else the workspace's checkpoint in the order
    ``sed_tpu`` looks: its Orbax directory (refused: it needs JAX to
    read), then the reference ``.pth``.  No checkpoint exits: the port
    cannot reproduce ``sed_tpu``'s fresh init, so it does not make one."""
    path = getattr(args, 'checkpoint', None)
    if path is not None:
        return path
    orbax = ws.checkpoint_path(args.feature_type, cfg.name)
    pth = ws.torch_checkpoint_path(args.feature_type, cfg.name)
    if os.path.isdir(orbax):
        raise SystemExit(
            f'{orbax} is an Orbax checkpoint directory, which needs JAX to '
            'read; export it with sed_tpu.utils.npz_ckpt.save_variables_npz '
            'and pass --checkpoint')
    if os.path.isfile(pth):
        return pth
    raise SystemExit(f'no checkpoint: pass --checkpoint (.npz or .pth) or '
                     f'put a reference checkpoint at {pth}; the port does '
                     'not initialise a model at random')


def build_model(args, cfg, ws):
    """The registry model with the checkpoint's weights, on
    ``args.device``, in eval mode.  Turns TF32 off first: the port's CUDA
    engine and evaluator refuse it."""
    from sed_tpu_torch.compat.from_flax import load_checkpoint
    from sed_tpu_torch.serve.engine import disable_tf32
    if args.feature_type != 'logmel':
        raise SystemExit(f'--feature_type {args.feature_type}: only logmel '
                         'is ported')
    path = checkpoint_path(args, cfg, ws)
    disable_tf32()
    try:
        return load_checkpoint(path, args.model_type, cfg, args.device)
    except ValueError as e:
        raise SystemExit(str(e)) from e

