"""Joint weak+strong training, test-set inference and metrics CLI
(counterpart of ``sed_tpu/cli/main_strong.py``).

    python -m sed_tpu_torch.cli.main_strong train --dataset_dir DS \\
        --workspace WS --audio_16k --augmentation specaugment_timeshift_mixup
    python -m sed_tpu_torch.cli.main_strong inference_prob_overlap \\
        --dataset_dir DS --workspace WS --audio_16k --device cuda

Modes, on the splits packed by ``python -m sed_tpu_torch.cli.features``
(``--feature_type logmel`` or ``gamma``; ``train`` and ``inference_prob``
take both, the windowed modes feed waveforms and take log-mel only):

* ``train``: the reference's loop (``pytorch/main_strong.py:40-413``):
  each iteration one joint step (``train/step.py``) on a weak batch and
  a strong batch (plus an FSD50K batch with ``--fsd50k``), fetched by a
  worker pool and copied to the device ahead of the step; every
  ``--eval_interval`` iterations an evaluation on ``strong_validation``
  and ``testing``, and the best checkpoint by validation framewise mAP
  and error rate saved as ``iter_<N>.pth`` + ``BEST`` in the workspace's
  checkpoint directory; ``--resume_iteration N`` restarts from the
  checkpoint at N.  ``train_loop`` is the loop on loaders it is given
  (``tools/torch_synthetic_learning_check.py`` feeds it from memory).
  ``--compute_dtype bf16`` runs the conv stack in
  bf16 with the dynamic loss-scaled step (parameters, optimizer state
  and ``.pth`` files stay float32).  Under ``torchrun --nproc_per_node
  N`` each process trains on ``cuda:LOCAL_RANK`` (gloo processes with
  ``--device cpu``) on its share of every batch, the step averaging the
  gradients (data parallel); every rank evaluates, rank 0 alone writes
  the checkpoints, statistics and submissions.  With ``--loss_type
  clip_bce_logits`` (for
  ``Cnn_7layers_Conformer`` / ``Cnn_9layers_Conformer``, whose outputs
  are logits) the strong loss is ``frame_bce_logits``;
* ``inference_prob``: one forward per 10 s clip (``Evaluator``), the
  submission CSV, micro P/R/F1/ER, and the ``test_predictions_*.pkl``
  pickle for offline threshold tuning;
* ``inference_prob_overlap``: overlapped windows merged by framewise
  averaging on the device (``predict_clips_windowed``), for each
  [overlap_value, window] of ``PARAM_COMBINATIONS``;
* ``inference_prob_vote``: per-window binarisation and vote counts.

The model comes from ``--checkpoint`` (.npz or .pth), the trainer's best
checkpoint or the workspace's ``.pth``; ``--device`` defaults to
``cuda``.  Training starts from a fresh initialisation, or from
``--checkpoint``.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import tempfile
import time

import numpy as np

from sed_tpu_torch import config
from sed_tpu_torch.cli import common
from sed_tpu_torch.data import audio_io
from sed_tpu_torch.eval import segment_metrics
from sed_tpu_torch.post import events as post_events
from sed_tpu_torch.post import merge as post_merge

PARAM_COMBINATIONS = [[0.5, 6], [0.5, 7], [1, 5], [1, 6], [1, 7]]


def _print_metrics(results: dict, prf: bool = False) -> None:
    from sed_tpu_torch.eval.calculate_metrics import get_metric
    if prf:
        print('Micro precision: {:.3f}'.format(
            get_metric(results, 'precision')))
        print('Micro recall: {:.3f}'.format(get_metric(results, 'recall')))
        print('Micro F1: {:.3f}'.format(get_metric(results, 'f1')))
        print('Micro ER: {:.3f}'.format(get_metric(results, 'er')))
    else:
        print('Micro F1: {:.3f}'.format(get_metric(results, 'f1')))
        print('Micro ER: {:.3f} \n'.format(get_metric(results, 'er')))


def _setup(args):
    cfg, ws = common.resolve(args)
    model = common.build_model(args, cfg, ws)
    sed_params = common.load_sed_params(args, cfg, ws,
                                        config.EVAL_SED_PARAMS)
    return cfg, ws, model, sed_params


def batch_sizes(args):
    """(weak, strong) batch sizes: the reference's INCLUDING its
    conditional precedence (``main_strong.py:229-236``): with mixup the
    weak stream draws (bs*3)*2; without mixup the x3 weak multiplier is
    dropped too."""
    if 'mixup' in args.augmentation:
        return (args.batch_size * 3) * 2, args.batch_size * 2
    return args.batch_size, args.batch_size


def train_setup(args):
    """Joins torchrun's process group (a no-op alone), checks that the
    processes share the batches, and runs ``common.setup_training``;
    returns (device, cfg, ws).  What ``train`` does before it reads
    data."""
    from sed_tpu_torch.parallel import distributed
    weak_bs, strong_bs = batch_sizes(args)
    # one process per card under torchrun (data parallel); no-op alone
    distributed.maybe_initialize(args.device)
    common.check_world_size(distributed.world_size(), weak_bs, strong_bs,
                            'mixup' in args.augmentation)
    return common.setup_training(
        args, distributed.local_device(args.device),
        log_to_file=distributed.rank() == 0)


def train_loaders(args, paths: dict, dataset=None, rows=None):
    """The loop's loaders over the packed splits ``paths`` (keys
    ``weak_training``, ``strong_training``, ``strong_fsd50k`` under
    ``--fsd50k``, ``strong_validation``, ``testing``): (weak loader,
    [strong loaders], valid loader, test loader).  ``dataset(**kwargs)``
    makes the datasets (``AudiosetDataset``, which reads the HDF5 files,
    by default); ``rows`` maps a path to its row count, so that the
    samplers need not open the file."""
    from sed_tpu_torch.data.dataset import (AudiosetDataset, DataLoader,
                                            TestSampler, TrainSampler)
    from sed_tpu_torch.parallel import distributed
    dataset = dataset or AudiosetDataset
    rows = rows or {}
    weak_bs, strong_bs = batch_sizes(args)
    # train streams ship int16 (or --train_wire) rows, decoded on the
    # device by the step; the eval loaders keep the float path
    train_dataset = dataset(dequantize=False, wire=args.train_wire)
    eval_dataset = dataset()

    def _train_loader(split, bs):
        # every process draws the same seeded global stream and loads
        # only its share
        path = paths[split]
        sampler = distributed.HostShardedSampler(
            TrainSampler(path, bs, audios_num=rows.get(path)),
            even_shares='mixup' in args.augmentation)
        return DataLoader(train_dataset, sampler,
                          num_workers=args.num_workers)

    def _eval_loader(split):
        path = paths[split]
        return DataLoader(eval_dataset, TestSampler(
            path, args.batch_size, audios_num=rows.get(path)))

    strong = ['strong_training'] + (['strong_fsd50k'] if args.fsd50k
                                    else [])
    return (_train_loader('weak_training', weak_bs),
            [_train_loader(split, strong_bs) for split in strong],
            _eval_loader('strong_validation'), _eval_loader('testing'))


def train(args):
    """Joint weak+strong training (``sed_tpu/cli/main_strong.py:39-276``)
    on the workspace's packed HDF5 splits."""
    device, cfg, ws = train_setup(args)
    splits = ('weak_training', 'strong_training', 'strong_validation',
              'testing') + (('strong_fsd50k',) if args.fsd50k else ())
    loaders = train_loaders(
        args, {split: common.hdf5_path(args, cfg, split) for split in splits})
    return train_loop(args, device, cfg, ws, *loaders,
                      common.reference_csv_paths(args))


def train_loop(args, device, cfg, ws, weak_loader, strong_loaders,
               valid_loader, test_loader, refs: dict, on_step=None,
               on_eval=None):
    """The training loop of ``train`` from the model on: the train state
    (fresh, ``--checkpoint`` or ``--resume_iteration``), the joint step
    on a weak batch and one batch of each strong loader an iteration,
    the evaluation on ``valid_loader`` and ``test_loader`` against the
    reference CSVs ``refs['valid']`` and ``refs['test']`` every
    ``--eval_interval`` iterations, the best checkpoint and the
    statistics.  ``on_step(iteration, metrics)`` is called after each
    step (the metrics as the step returns them, on the device) and
    ``on_eval(iteration, {'valid': statistics, 'test': statistics},
    train_s, eval_s)`` after each evaluation, when given.  Returns the
    train state."""
    import torch
    import torch.distributed as dist
    from sed_tpu_torch import losses as losses_lib
    from sed_tpu_torch.augment.functional import MixupGenerator
    from sed_tpu_torch.data.dataset import cycle_iteration
    from sed_tpu_torch.eval.evaluator import Evaluator
    from sed_tpu_torch.parallel import distributed
    from sed_tpu_torch.train.checkpoint import save_best_checkpoint
    from sed_tpu_torch.train.prefetch import device_prefetch
    from sed_tpu_torch.train.step import init_loss_scale, make_train_step
    from sed_tpu_torch.utils.statistics import StatisticsContainer

    mixup = 'mixup' in args.augmentation
    timeshift = 'timeshift' in args.augmentation
    spec_augment = 'specaugment' in args.augmentation
    parallel = dist.is_available() and dist.is_initialized()
    world, rank = distributed.world_size(), distributed.rank()
    weak_iter = cycle_iteration(weak_loader)
    strong_iters = [cycle_iteration(loader) for loader in strong_loaders]

    state = common.train_state(args, cfg, device)
    ckpt_dir = ws.checkpoint_path(args.feature_type, cfg.name, create=True)
    statistics_container = StatisticsContainer(
        ws.statistics_path(args.feature_type, cfg.name, create=True))
    iteration = common.resume_training(args, state, ckpt_dir,
                                       statistics_container)

    # the token-pooling Conformers put out logits: ``--loss_type
    # clip_bce_logits`` takes the strong loss on logits too
    strong_loss_type = 'frame_bce_logits' \
        if args.loss_type.endswith('_logits') else 'frame_bce'
    # bf16 trains with the dynamic loss scale and its non-finite skip
    # (``sed_tpu/cli/main_strong.py:146-156``)
    use_loss_scale = state.model.compute_dtype is not None
    step_fn = make_train_step(
        state.model, state.optimizer,
        losses_lib.get_loss_func(args.loss_type),
        losses_lib.get_loss_func(strong_loss_type), mixup=mixup,
        timeshift=timeshift, spec_augment=spec_augment,
        loss_scale='dynamic' if use_loss_scale else None,
        wire_samples=cfg.audio_samples,
        group=dist.group.WORLD if parallel else None)
    scale_state = init_loss_scale() if use_loss_scale else None
    evaluator = Evaluator(state.model, device, config.EVAL_SED_PARAMS)
    # every rank evaluates (identical replicated parameters); ranks other
    # than 0 write their submission to a directory of their own
    scratch = None if rank == 0 else tempfile.TemporaryDirectory()
    submission = ws.submission_path(create=True) if rank == 0 else \
        os.path.join(scratch.name, 'submission.tsv')
    mixup_gen = MixupGenerator(mixup_alpha=1.0)

    def _local_lambda(n_local):
        # every process draws the same GLOBAL lambda stream and keeps its
        # slice, so mixup pairing is consistent across processes
        lam = mixup_gen.get_lambda(n_local * world).astype(np.float32)
        return lam[rank * n_local:(rank + 1) * n_local]

    def _assemble_batches():
        # runs in the prefetch thread: draw, pair mixup lambdas, strip
        # host-only fields; the order weak, then each strong stream, is
        # the lambda stream's
        while True:
            weak_batch = next(weak_iter)
            strong_batches = [next(it) for it in strong_iters]
            if mixup:
                for b in (weak_batch, *strong_batches):
                    b['mixup_lambda'] = _local_lambda(len(b['waveform']))
            for b in (weak_batch, *strong_batches):
                b.pop('audio_name', None)
            weak_batch.pop('strong_target', None)
            yield weak_batch, strong_batches

    # copy batch k+1 to the device while the step runs batch k
    batch_iter = device_prefetch(_assemble_batches(), size=2, device=device)

    best_er, best_map, best_iteration = 10000.0, 0.0, 0
    # every draw of the steps (SpecAugment, timeshift, dropout) comes
    # from this generator on the device; sed_tpu's PRNGKey(1234)
    generator = torch.Generator(device=device).manual_seed(1234)
    train_bgn_time = time.time()

    while iteration != args.stop_iteration:
        if (iteration % args.eval_interval == 0
                and iteration > args.resume_iteration):
            logging.info('------------------------------------')
            logging.info('Iteration: %d', iteration)
            train_fin_time = time.time()
            evaluated = {}
            for data_type, loader, ref_csv in [
                    ('valid', valid_loader, refs['valid']),
                    ('test', test_loader, refs['test'])]:
                statistics, _ = evaluator.evaluate(
                    loader, ref_csv, submission, cfg.frames_per_second)
                logging.info('%s statistics:', data_type)
                logging.info('    Clipwise mAP: %.3f',
                             np.nanmean(statistics['clipwise_ap']))
                logging.info('    Framewise mAP: %.3f',
                             np.nanmean(statistics['framewise_ap']))
                logging.info(
                    '    %s',
                    statistics['sed_metrics']['overall']['error_rate'])
                statistics_container.append(data_type, iteration,
                                            statistics)
                evaluated[data_type] = statistics
                if data_type == 'valid':
                    fmap = np.nanmean(statistics['framewise_ap'])
                    er = statistics['sed_metrics']['overall'][
                        'error_rate']['error_rate']
                    if fmap >= best_map and er < best_er:
                        best_map, best_er, best_iteration = \
                            fmap, er, iteration
                        if rank == 0:
                            saved = save_best_checkpoint(ckpt_dir, state)
                            logging.info('Model saved to %s for iteration '
                                         '%d', saved, iteration)
            if rank == 0:
                statistics_container.dump()
            if parallel:
                dist.barrier()
            train_s = train_fin_time - train_bgn_time
            eval_s = time.time() - train_fin_time
            logging.info('Train time: %.3f s, validate time: %.3f s',
                         train_s, eval_s)
            if on_eval is not None:
                on_eval(iteration, evaluated, train_s, eval_s)
            train_bgn_time = time.time()

        weak_batch, strong_batches = next(batch_iter)
        if use_loss_scale:
            metrics, scale_state = step_fn(weak_batch, strong_batches,
                                           generator, scale_state)
        else:
            metrics = step_fn(weak_batch, strong_batches, generator)
        if on_step is not None:
            on_step(iteration, metrics)
        if iteration % 100 == 0:
            logging.info(
                '%d iteration - weak: %.4f, strong: %.4f, total: %.4f%s',
                iteration, float(metrics['weak_loss']),
                float(metrics['strong_loss']), float(metrics['loss']),
                f', loss scale {scale_state.scale}' if use_loss_scale
                else '')

        iteration += 1
        if iteration == args.stop_iteration:
            logging.info('    Best iteration: %d', best_iteration)
            break
    batch_iter.close()
    if scratch is not None:
        scratch.cleanup()
    return state


def inference_prob(args):
    """Batch test-set inference + metrics."""
    from sed_tpu_torch.data.dataset import (AudiosetDataset, DataLoader,
                                            TestSampler)
    from sed_tpu_torch.eval.evaluator import Evaluator
    cfg, ws, model, sed_params = _setup(args)
    refs = common.reference_csv_paths(args)
    test_loader = DataLoader(
        AudiosetDataset(),
        TestSampler(common.hdf5_path(args, cfg, 'testing'),
                    args.batch_size))
    evaluator = Evaluator(model, args.device, sed_params)
    submission = ws.submission_path(create=True)

    t0 = time.time()
    statistics, output_dict = evaluator.evaluate(
        test_loader, refs['test'], submission, cfg.frames_per_second)
    print('Processing time: {} s\n'.format(time.time() - t0))
    _print_metrics(statistics['sed_metrics'], prf=True)

    pred_path = ws.predictions_path(
        f'test_predictions_{args.feature_type}_{cfg.name}.pkl', create=True)
    with open(pred_path, 'wb') as f:
        pickle.dump(output_dict, f)
    return statistics


def _engine(args, cfg, model, sed_params, overlap_value, sample_duration):
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    return SedInferenceEngine(
        model, cfg, args.device, sample_duration=sample_duration,
        overlap=True, overlap_value=overlap_value, sed_params=sed_params,
        batch_size=args.batch_size)


def _test_clip_waveforms(args, cfg):
    """Yield (audio_name, 10 s float32 waveform) for every clip of the
    packed test split."""
    import h5py
    from sed_tpu_torch.data.hdf5_pack import int16_to_float32
    with h5py.File(common.hdf5_path(args, cfg, 'testing'), 'r') as hf:
        for i in range(len(hf['audio_name'])):
            yield (hf['audio_name'][i].decode(),
                   int16_to_float32(hf['waveform'][i]))


def _score(full_event_list, refs, submission) -> dict:
    post_events.write_submission(full_event_list, submission)
    results = segment_metrics.official_evaluate(refs['test'], submission)
    _print_metrics(results)
    return results


def inference_prob_overlap(args):
    """Sliding-window inference with framewise averaging over the
    [overlap_value, window] grid, merged on the device."""
    common.refuse_features(args, 'inference_prob_overlap')
    cfg, ws, model, sed_params = _setup(args)
    refs = common.reference_csv_paths(args)
    submission = ws.submission_path(create=True)

    all_results = {}
    for overlap_value, sample_duration in PARAM_COMBINATIONS:
        engine = _engine(args, cfg, model, sed_params, overlap_value,
                         sample_duration)
        t0 = time.time()
        pairs = list(_test_clip_waveforms(args, cfg))
        names = [n for n, _ in pairs]
        wavs = audio_io.stack_rows(a for _, a in pairs)
        per_clip = engine.predict_clips_windowed(
            wavs, names, duration=10.0, step=overlap_value)
        print('Processing time for {}: {} s'.format(
            [overlap_value, sample_duration], time.time() - t0))
        all_results[(overlap_value, sample_duration)] = _score(
            [e for evs in per_clip for e in evs], refs, submission)
    return all_results


def inference_prob_vote(args):
    """Sliding-window inference with per-window binarisation against the
    high threshold and overlap-added vote counts."""
    from sed_tpu_torch.serve.engine import window_starts
    common.refuse_features(args, 'inference_prob_vote')
    cfg, ws, model, sed_params = _setup(args)
    refs = common.reference_csv_paths(args)
    thr = np.asarray(
        sed_params.per_class(config.CLASSES_NUM)['sed_high_threshold'])
    submission = ws.submission_path(create=True)
    sr = cfg.sample_rate

    all_results = {}
    for overlap_value, sample_duration in PARAM_COMBINATIONS:
        engine = _engine(args, cfg, model, sed_params, overlap_value,
                         sample_duration)
        t0 = time.time()
        full_event_list = []
        for audio_name, audio in _test_clip_waveforms(args, cfg):
            starts = window_starts(10.0, sample_duration, True,
                                   overlap_value)
            windows = np.stack([
                audio_io.pad_truncate(
                    audio[int(s * sr):int(s * sr) + engine.window_samples],
                    engine.window_samples)
                for s in starts])
            framewise, _ = engine.infer_framewise(windows)
            binary = (framewise > thr[None, None, :]).astype(np.float64)
            votes = post_merge.overlap_add_windows(
                binary, sample_duration, overlap_value, normalize=False)
            full_event_list.extend(
                post_events.frame_binary_prediction_to_event_prediction(
                    votes, overlap_value, sample_duration, audio_name,
                    sed_params, cfg.frames_per_second))
        print('Processing time for {}: {} s'.format(
            [overlap_value, sample_duration], time.time() - t0))
        all_results[(overlap_value, sample_duration)] = _score(
            full_event_list, refs, submission)
    return all_results


def add_train_args(sub) -> None:
    """``main_strong train``'s flags (``sed_tpu/cli/main_strong.py:428-454``)
    and ``--device`` / ``--checkpoint``."""
    sub.add_argument('--learning_rate', type=float, default=1e-3)
    sub.add_argument('--stop_iteration', type=int, default=50000)
    sub.add_argument('--resume_iteration', type=int, default=0)
    sub.add_argument('--eval_interval', type=int, default=1000)
    sub.add_argument('--fsd50k', action='store_true', default=False)
    sub.add_argument('--compute_dtype', type=str, default='f32',
                     choices=['f32', 'bf16'],
                     help='conv-stack computation dtype; bf16 trains with '
                          'the dynamic loss scale (parameters, optimizer '
                          'state and checkpoints stay float32)')
    sub.add_argument('--num_workers', type=int, default=2,
                     help='data-loader fetch threads (the reference uses '
                          '8 torch workers)')
    sub.add_argument('--train_wire', type=str, default='int16',
                     choices=['int16', 'mulaw8', 'q6', 'q5', 'q4', 'adpcm4'],
                     help='waveform wire format of the train batches, '
                          'decoded on the device: int16 (exact, default), '
                          'mulaw8 (2x fewer host->device bytes), q6/q5/q4 '
                          'block-scaled (~5.2-7.8x fewer), adpcm4 IMA '
                          'ADPCM (~3.9x fewer)')
    common.add_model_args(sub, train=True)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='sed_tpu_torch main_strong')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    sub = subparsers.add_parser('train')
    common.add_common_args(sub)
    add_train_args(sub)
    for mode in ('inference_prob', 'inference_prob_overlap',
                 'inference_prob_vote'):
        sub = subparsers.add_parser(mode)
        common.add_common_args(sub)
        common.add_model_args(sub)
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    return {'train': train,
            'inference_prob': inference_prob,
            'inference_prob_overlap': inference_prob_overlap,
            'inference_prob_vote': inference_prob_vote}[args.mode](args)


if __name__ == '__main__':
    main()
