"""Threshold-optimization CLI (counterpart of
``sed_tpu/cli/optimize_thresholds.py``), on the numpy optimizer
``thresholds/optimizer.py`` (a copy of ``sed_tpu``'s).

* ``optimize_sed_thresholds``: run validation inference once with the
  port's ``Evaluator`` (``--device``, default ``cuda``), cache the
  prediction pickle, optimize the 75-dim threshold vector against the
  official segment-based F1, dump ``best_{feat}_{quality}.sed.valid.pkl``
  (what ``predict --sed_thresholds`` reads);
* ``optimize_at_thresholds``: 25 clipwise thresholds against micro F1 of
  the test predictions that ``main_strong inference_prob`` cached.

    python -m sed_tpu_torch.cli.optimize_thresholds optimize_sed_thresholds \\
        --dataset_dir DS --workspace WS --audio_16k --device cuda
"""

from __future__ import annotations

import argparse
import os
import pickle

from sed_tpu_torch import config
from sed_tpu_torch.cli import common


def _optimize(score_calculator, args, init_params):
    from sed_tpu_torch.thresholds.optimizer import HyperParamsOptimizer
    opt = HyperParamsOptimizer(score_calculator,
                               learning_rate=args.learning_rate,
                               epochs=args.epochs, step=0.02, max_search=5)
    return opt.do_optimize(init_params)


def optimize_sed_thresholds(args):
    from sed_tpu_torch.thresholds.optimizer import \
        SoundEventDetectionScoreCalculator
    cfg, ws = common.resolve(args)
    refs = common.reference_csv_paths(args)
    pred_path = ws.predictions_path(
        f'valid_predictions_{args.feature_type}_{cfg.name}.pkl',
        create=True)
    submission = ws.submission_path(create=True)

    if not os.path.isfile(pred_path) or args.refresh_predictions:
        from sed_tpu_torch.data.dataset import (AudiosetDataset,
                                                DataLoader, TestSampler)
        from sed_tpu_torch.eval.evaluator import Evaluator
        model = common.build_model(args, cfg, ws)
        valid_loader = DataLoader(
            AudiosetDataset(),
            TestSampler(common.hdf5_path(args, cfg, 'strong_validation'),
                        args.batch_size))
        _, output_dict = Evaluator(model, args.device).evaluate(
            valid_loader, refs['valid'], submission, cfg.frames_per_second)
        with open(pred_path, 'wb') as f:
            pickle.dump(output_dict, f)
        print('cached validation predictions to', pred_path)

    score_calculator = SoundEventDetectionScoreCalculator(
        prediction_path=pred_path, reference_csv_path=refs['valid'],
        submission_path=submission, classes_num=config.CLASSES_NUM,
        frames_per_second=cfg.frames_per_second)
    # init {tag .5, high .3, low .1}, as sed_tpu
    n = config.CLASSES_NUM
    score, params, record = _optimize(score_calculator, args,
                                      [0.5] * n + [0.3] * n + [0.1] * n)

    out_path = ws.sed_thresholds_path(args.feature_type, cfg.name,
                                      create=True)
    with open(out_path, 'wb') as f:
        pickle.dump(score_calculator.params_list_to_params_dict(params), f)
    with open(out_path + '.record', 'wb') as f:
        pickle.dump(record, f)
    print('Saved optimized thresholds (F1 {:.4f}) to {}'.format(
        score, out_path))
    return score, params


def optimize_at_thresholds(args):
    """Audio-tagging (clipwise) threshold optimization on the cached test
    predictions; runs no model."""
    from sed_tpu_torch.thresholds.optimizer import AudioTaggingScoreCalculator
    cfg, ws = common.resolve(args)
    pred_path = ws.predictions_path(
        f'test_predictions_{args.feature_type}_{cfg.name}.pkl')
    if not os.path.isfile(pred_path):
        raise SystemExit(
            f'no cached predictions at {pred_path}; run '
            'main_strong inference_prob first')
    score, params, record = _optimize(AudioTaggingScoreCalculator(pred_path),
                                      args, [0.3] * config.CLASSES_NUM)
    out_path = os.path.join(
        ws.dir('opt_thresholds', create=True),
        f'best_{args.feature_type}_{cfg.name}.at.pkl')
    with open(out_path, 'wb') as f:
        pickle.dump({'audio_tagging_threshold': list(params)}, f)
    print('Saved optimized AT thresholds (F1 {:.4f}) to {}'.format(
        score, out_path))
    return score, params


def get_parser():
    parser = argparse.ArgumentParser(
        description='sed_tpu_torch threshold optimization')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    for mode in ('optimize_sed_thresholds', 'optimize_at_thresholds'):
        sub = subparsers.add_parser(mode)
        common.add_common_args(sub)
        sub.add_argument('--learning_rate', type=float, default=1e-2)
        sub.add_argument('--epochs', type=int, default=70)
        sub.add_argument('--refresh_predictions', action='store_true',
                         default=False)
        if mode == 'optimize_sed_thresholds':
            common.add_model_args(sub)
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.mode == 'optimize_sed_thresholds':
        return optimize_sed_thresholds(args)
    return optimize_at_thresholds(args)


if __name__ == '__main__':
    main()
