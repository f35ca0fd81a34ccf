"""Shared CLI plumbing of the port: quality flags, workspace paths and
threshold pickles (a copy of ``sed_tpu/cli/common.py``'s) and model
loading (counterpart of its JAX-only ``build_model_and_variables``):
``--checkpoint``, else the trainer's best checkpoint, else the
workspace's reference ``.pth``; the training CLIs' shared set-up.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Tuple

from sed_tpu_torch.config import AudioConfig, SedParams, get_audio_config
from sed_tpu_torch.utils.paths import Workspace


def add_common_args(parser: argparse.ArgumentParser,
                    require_dataset: bool = True):
    parser.add_argument('--dataset_dir', type=str,
                        required=require_dataset,
                        help='Directory of the dataset.')
    parser.add_argument('--workspace', type=str, required=True,
                        help='Directory of your workspace.')
    parser.add_argument('--filename', type=str, default='main_strong')
    parser.add_argument('--holdout_fold', type=str, default='1',
                        choices=['1'])
    parser.add_argument('--model_type', type=str,
                        default='Cnn_9layers_Gru_FrameAtt')
    parser.add_argument('--loss_type', type=str, default='clip_bce')
    # reference quirk preserved: the choice list (README.md's
    # augmentation list) spells the standalone option 'spec_augment'
    # with an underscore, but dispatch tests `'specaugment' in
    # augmentation` (``main_strong.py:278``) — so 'spec_augment' trains
    # with NO augmentation in the reference and here alike; use a
    # 'specaugment_*' combo for SpecAugment
    parser.add_argument('--augmentation', type=str, default='none',
                        choices=['none', 'spec_augment', 'timeshift',
                                 'mixup', 'timeshift_mixup',
                                 'specaugment_timeshift_mixup',
                                 'specaugment_mixup',
                                 'specaugment_timeshift'])
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--feature_type', type=str, default='logmel')
    parser.add_argument('--audio_8k', action='store_true', default=False)
    parser.add_argument('--audio_16k', action='store_true', default=False)
    parser.add_argument('--mini_data', action='store_true', default=False)
    parser.add_argument('--sed_thresholds', action='store_true',
                        default=False)
    # accepted for reference-CLI compatibility; the device is --device
    parser.add_argument('--cuda', action='store_true', default=False)


def resolve(args) -> Tuple[AudioConfig, Workspace]:
    cfg = get_audio_config(audio_8k=args.audio_8k, audio_16k=args.audio_16k)
    ws = Workspace(root=args.workspace, filename=args.filename,
                   holdout_fold=args.holdout_fold,
                   model_type=args.model_type, loss_type=args.loss_type,
                   augmentation=args.augmentation,
                   batch_size=args.batch_size)
    return cfg, ws


def hdf5_path(args, cfg: AudioConfig, data_type: str) -> str:
    prefix = 'minidata_' if args.mini_data else ''
    return os.path.join(
        args.workspace, 'hdf5s',
        f'{prefix}{data_type}_{args.feature_type}_{cfg.name}.h5')


def reference_csv_paths(args) -> dict:
    """Ground-truth csv layout (``pytorch/main_strong.py:141-146``)."""
    return {
        'valid': os.path.join(
            args.dataset_dir, 'metadata', 'strong',
            'groundtruth_strong_label_strong_validation_set.csv'),
        'test': os.path.join(
            args.dataset_dir, 'metadata',
            'groundtruth_strong_label_testing_set.csv'),
    }


def load_sed_params(args, cfg: AudioConfig, ws: Workspace,
                    default):
    """Optimized thresholds pickle or defaults
    (``pytorch/predict.py:244-257``)."""
    if args.sed_thresholds:
        import pickle
        with open(ws.sed_thresholds_path(args.feature_type, cfg.name),
                  'rb') as f:
            return SedParams.from_dict(pickle.load(f))
    return default


def add_model_args(parser, train: bool = False) -> None:
    """``--checkpoint`` and ``--device`` (default ``cuda``: the entry
    points run on the card unless asked for the CPU)."""
    parser.add_argument(
        '--checkpoint', type=str, default=None,
        help=('sed_tpu .npz or reference-layout .pth weights to start '
              'from (default: a fresh initialisation)') if train else
             ('sed_tpu .npz or reference .pth checkpoint (default: the '
              "workspace's best checkpoint, then its .pth)"))
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device to run on (default 'cuda'; "
                             "'cpu' asks for the CPU)")


def checkpoint_path(args, cfg, ws) -> str:
    """``--checkpoint``, else the workspace's checkpoint in the order
    ``sed_tpu`` looks: the lineage directory at the checkpoint stem (its
    ``BEST`` marker, else its highest ``iter_<N>.pth``; what the port's
    trainer saves), then the reference ``.pth``.  A ``sed_tpu`` Orbax
    checkpoint there is refused: it needs JAX to read.  No checkpoint
    exits: the port does not serve a random initialisation."""
    from sed_tpu_torch.train.checkpoint import (best_checkpoint_path,
                                                is_orbax_checkpoint)
    path = getattr(args, 'checkpoint', None)
    if path is not None:
        return path
    stem = ws.checkpoint_path(args.feature_type, cfg.name)
    pth = ws.torch_checkpoint_path(args.feature_type, cfg.name)
    if os.path.isdir(stem):
        best = best_checkpoint_path(stem)
        if best is not None and os.path.isfile(best):
            return best
        if is_orbax_checkpoint(stem) or any(
                is_orbax_checkpoint(os.path.join(stem, d))
                for d in os.listdir(stem)):
            raise SystemExit(
                f'{stem} holds an Orbax checkpoint, which needs JAX to '
                'read; export it with sed_tpu.utils.npz_ckpt.'
                'save_variables_npz and pass --checkpoint')
    if os.path.isfile(pth):
        return pth
    raise SystemExit(f'no checkpoint: pass --checkpoint (.npz or .pth), '
                     f'train one into {stem}, or put a reference checkpoint '
                     f'at {pth}; the port does not serve a random '
                     'initialisation')


def build_model(args, cfg, ws):
    """The registry model with the checkpoint's weights, on
    ``args.device``, in eval mode.  Turns TF32 off first: the port's CUDA
    engine and evaluator refuse it."""
    from sed_tpu_torch.compat.from_flax import load_checkpoint
    from sed_tpu_torch.serve.engine import check_device, disable_tf32
    path = checkpoint_path(args, cfg, ws)
    disable_tf32()
    check_device(args.device)
    try:
        return load_checkpoint(path, args.model_type, cfg, args.device,
                               feature_type=args.feature_type)
    except ValueError as e:
        raise SystemExit(str(e)) from e


def refuse_features(args, mode: str) -> None:
    """Exit before anything loads when ``mode`` feeds waveforms and
    ``--feature_type`` names packed features (``sed_tpu`` fails there
    too, in the forward)."""
    from sed_tpu_torch.serve.engine import refuse_features
    try:
        refuse_features(args.feature_type, mode)
    except ValueError as e:
        raise SystemExit(f'--feature_type {args.feature_type}: {e}') from e


def setup_training(args, device=None, log_to_file: bool = True):
    """Checks, TF32 off, device, logging: what both training CLIs do
    before they touch the workspace's data.  A flag that cannot train
    exits before any workspace directory exists.  ``device`` replaces
    ``args.device`` (a torchrun rank's ``cuda:LOCAL_RANK``); without
    ``log_to_file`` (ranks other than 0) nothing is written to the
    workspace's log directory."""
    from sed_tpu_torch.serve.engine import check_device, disable_tf32
    from sed_tpu_torch.utils.logging_utils import create_logging
    if (args.feature_type == 'gamma'
            and getattr(args, 'train_wire', 'int16') != 'int16'):
        raise SystemExit(
            "--train_wire: mu-law/qN wires compress raw AUDIO; "
            "feature_type='gamma' packs precomputed gammatone features "
            "as 'waveform' (data/hdf5_pack.py) — use the default int16")
    disable_tf32()
    device = check_device(args.device if device is None else device)
    cfg, ws = resolve(args)
    if log_to_file:
        create_logging(ws.logs_dir(create=True))
    logging.info(args)
    return device, cfg, ws


def check_world_size(world: int, weak_bs: int, strong_bs: int,
                     mixup: bool) -> None:
    """Exit unless ``world`` processes split the weak and the strong
    batch evenly, into even shares under mixup (a mixup pair must stay
    on one process).  ``sed_tpu`` shrinks its mesh to fit; a launched
    process count cannot shrink."""
    for name, bs in (('weak', weak_bs), ('strong', strong_bs)):
        if bs % world or (mixup and (bs // world) % 2):
            raise SystemExit(
                f'{world} processes cannot share the {name} batch of {bs} '
                f'(weak {weak_bs}, strong {strong_bs}'
                f'{", mixup: even shares" if mixup else ""}); launch a '
                'process count that divides both')


def train_state(args, cfg, device):
    """The registry model, drawn fresh from a generator seeded 0 (or
    loaded from ``--checkpoint``), on ``device``, with its AMSGrad; its
    conv stack computes in ``--compute_dtype``."""
    import torch
    from sed_tpu_torch.compat.from_flax import load_checkpoint
    from sed_tpu_torch.models.registry import get_model
    from sed_tpu_torch.train.state import create_train_state
    from sed_tpu_torch.utils.logging_utils import count_parameters
    # ``main train`` has no --compute_dtype: float32
    dtype = torch.bfloat16 \
        if getattr(args, 'compute_dtype', 'f32') == 'bf16' else None
    if args.checkpoint is not None:
        model = load_checkpoint(args.checkpoint, args.model_type, cfg, 'cpu',
                                feature_type=args.feature_type,
                                compute_dtype=dtype)
    else:
        model = get_model(args.model_type, cfg,
                          feature_type=args.feature_type,
                          compute_dtype=dtype)
    state = create_train_state(
        model, args.learning_rate, torch.Generator().manual_seed(0),
        fresh=args.checkpoint is None)
    state.model.to(device)
    count_parameters(state.model)        # utilities.py:17-27 table
    return state


def resume_training(args, state, ckpt_dir, statistics_container) -> int:
    """Restore the checkpoint saved at exactly ``--resume_iteration``
    and drop the statistics recorded past it; returns the iteration."""
    from sed_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                resume_checkpoint_path)
    if args.resume_iteration <= 0:
        return 0
    resume_path = resume_checkpoint_path(ckpt_dir, args.resume_iteration)
    restore_checkpoint(resume_path, state)
    logging.info('resumed from %s at iteration %d', resume_path, state.step)
    if os.path.isfile(statistics_container.statistics_path):
        # utils/utilities.py:358-371
        statistics_container.load_state_dict(args.resume_iteration)
    return state.step
