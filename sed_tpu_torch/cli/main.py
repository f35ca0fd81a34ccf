"""Weakly supervised training CLI (counterpart of ``sed_tpu/cli/main.py``,
the working equivalent of the reference's ``pytorch/main.py:30-278``).

    python -m sed_tpu_torch.cli.main train --dataset_dir DS --workspace WS \\
        --audio_16k --model_type Cnn_9layers_FrameAvg --augmentation mixup
    python -m sed_tpu_torch.cli.main inference_prob --dataset_dir DS \\
        --workspace WS --audio_16k --model_type Cnn_9layers_FrameAvg

``train``: a single weak stream (the ``training`` split), the clip loss,
an evaluation every ``--eval_interval`` iterations on ``testing``, and
the best checkpoint by clipwise mAP saved as ``iter_<N>.pth`` + ``BEST``
(``sed_tpu`` saves one Orbax directory); ``--resume_iteration N``
restarts from the checkpoint at N (the port's addition: the reference's
weak-only CLI has no resume).  ``inference_prob``: the best checkpoint on
``testing``, metrics and the prediction pickle.  ``--device`` defaults
to ``cuda``.
"""

from __future__ import annotations

import argparse
import logging
import pickle
import time

import numpy as np

from sed_tpu_torch import config
from sed_tpu_torch.cli import common


def train(args):
    import torch
    from sed_tpu_torch import losses as losses_lib
    from sed_tpu_torch.augment.functional import MixupGenerator
    from sed_tpu_torch.data.dataset import (AudiosetDataset, DataLoader,
                                            TestSampler, TrainSampler,
                                            cycle_iteration)
    from sed_tpu_torch.eval.evaluator import Evaluator
    from sed_tpu_torch.train.checkpoint import save_best_checkpoint
    from sed_tpu_torch.train.prefetch import device_prefetch
    from sed_tpu_torch.train.step import make_train_step
    from sed_tpu_torch.utils.statistics import StatisticsContainer

    device, cfg, ws = common.setup_training(args)
    mixup = 'mixup' in args.augmentation
    timeshift = 'timeshift' in args.augmentation
    spec_augment = 'specaugment' in args.augmentation

    refs = common.reference_csv_paths(args)
    train_h5 = common.hdf5_path(args, cfg, 'training')
    test_h5 = common.hdf5_path(args, cfg, 'testing')
    dataset = AudiosetDataset()
    train_bs = args.batch_size * 2 if mixup else args.batch_size
    train_iter = cycle_iteration(
        DataLoader(dataset, TrainSampler(train_h5, train_bs)))
    test_loader = DataLoader(dataset, TestSampler(test_h5,
                                                  args.batch_size))

    state = common.train_state(args, cfg, device)
    ckpt_dir = ws.checkpoint_path(args.feature_type, cfg.name, create=True)
    statistics_container = StatisticsContainer(
        ws.statistics_path(args.feature_type, cfg.name, create=True))
    iteration = common.resume_training(args, state, ckpt_dir,
                                       statistics_container)

    # the weak-only loss is the joint step's with no strong stream
    step_fn = make_train_step(
        state.model, state.optimizer,
        losses_lib.get_loss_func(args.loss_type), None, mixup=mixup,
        timeshift=timeshift, spec_augment=spec_augment)
    evaluator = Evaluator(state.model, device, config.EVAL_SED_PARAMS)
    submission = ws.submission_path(create=True)
    mixup_gen = MixupGenerator(mixup_alpha=1.0)

    def _batches():
        while True:
            batch = next(train_iter)
            batch.pop('audio_name', None)
            batch.pop('strong_target', None)
            if mixup:
                batch['mixup_lambda'] = mixup_gen.get_lambda(
                    len(batch['waveform'])).astype(np.float32)
            yield batch

    batch_iter = device_prefetch(_batches(), size=2, device=device)
    best_map = 0.0
    generator = torch.Generator(device=device).manual_seed(1234)
    while iteration != args.stop_iteration:
        if (iteration % args.eval_interval == 0
                and iteration > args.resume_iteration):
            logging.info('Iteration: %d', iteration)
            statistics, _ = evaluator.evaluate(
                test_loader, refs['test'], submission,
                cfg.frames_per_second)
            cmap = np.nanmean(statistics['clipwise_ap'])
            logging.info('    Clipwise mAP: %.3f', cmap)
            statistics_container.append('test', iteration, statistics)
            statistics_container.dump()
            if cmap >= best_map:
                best_map = cmap
                saved = save_best_checkpoint(ckpt_dir, state)
                logging.info('Model saved to %s', saved)

        metrics = step_fn(next(batch_iter), [], generator)
        if iteration % 100 == 0:
            logging.info('%d iteration - loss: %.4f', iteration,
                         float(metrics['loss']))
        iteration += 1
    batch_iter.close()
    return state


def inference_prob(args):
    """Test-set inference + metrics + prediction-pickle dump of the
    weak-only CLI (``pytorch/main.py:281-380``): the best checkpoint on
    the testing split."""
    from sed_tpu_torch.data.dataset import (AudiosetDataset, DataLoader,
                                            TestSampler)
    from sed_tpu_torch.eval.calculate_metrics import get_metric
    from sed_tpu_torch.eval.evaluator import Evaluator

    cfg, ws = common.resolve(args)
    refs = common.reference_csv_paths(args)
    model = common.build_model(args, cfg, ws)
    test_loader = DataLoader(
        AudiosetDataset(),
        TestSampler(common.hdf5_path(args, cfg, 'testing'), args.batch_size))
    evaluator = Evaluator(model, args.device, config.EVAL_SED_PARAMS)
    submission = ws.submission_path(create=True)
    t0 = time.time()
    statistics, output_dict = evaluator.evaluate(
        test_loader, refs['test'], submission, cfg.frames_per_second)
    results = statistics['sed_metrics']
    print('Processing time: {} s\n'.format(time.time() - t0))
    print('Micro F1: {:.3f}'.format(get_metric(results, 'f1')))
    print('Micro ER: {:.3f}'.format(get_metric(results, 'er')))
    pred_path = ws.predictions_path(
        f'test_predictions_{args.feature_type}_{cfg.name}.pkl',
        create=True)
    with open(pred_path, 'wb') as f:
        pickle.dump(output_dict, f)
    print('Write out to {}'.format(pred_path))
    return statistics


def get_parser():
    parser = argparse.ArgumentParser(description='sed_tpu_torch main (weak)')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    sub = subparsers.add_parser('train')
    common.add_common_args(sub)
    sub.add_argument('--learning_rate', type=float, default=1e-3)
    sub.add_argument('--stop_iteration', type=int, default=50000)
    sub.add_argument('--eval_interval', type=int, default=1000)
    sub.add_argument('--resume_iteration', type=int, default=0)
    common.add_model_args(sub, train=True)
    sub_ip = subparsers.add_parser('inference_prob')
    common.add_common_args(sub_ip)
    sub_ip.add_argument('--iteration', type=int, default=None,
                        help='reference-compat no-op: the best checkpoint '
                             'is used')
    common.add_model_args(sub_ip)
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.mode == 'inference_prob':
        return inference_prob(args)
    return train(args)


if __name__ == '__main__':
    main()
