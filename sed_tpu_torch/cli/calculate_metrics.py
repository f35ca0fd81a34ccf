"""Offline metric calculation from cached predictions (a copy of
``sed_tpu/cli/calculate_metrics.py`` on the port's own modules,
``utils/calculate_metrics.py:52-196``).

Recomputes clipwise P/R/F1 (optionally with optimized AT thresholds) and
segment-based SED metrics (optionally with optimized SED thresholds) from
a prediction pickle — no model forward needed.
"""

from __future__ import annotations

import argparse
import os
import pickle

from sed_tpu_torch.cli import common
from sed_tpu_torch.config import CLASSES_NUM, EVAL_SED_PARAMS
from sed_tpu_torch.eval.calculate_metrics import (
    calculate_precision_recall_f1, get_metric)
from sed_tpu_torch.eval import segment_metrics
import sed_tpu_torch.post.events as post_events


def calculate_metrics(args):
    cfg, ws = common.resolve(args)
    if args.data_type == 'test':
        reference_csv_path = common.reference_csv_paths(args)['test']
    else:
        reference_csv_path = os.path.join(
            args.dataset_dir, 'metadata',
            'groundtruth_strong_label_evaluation_set.csv')

    pred_path = ws.predictions_path(
        f'{args.data_type}_predictions_{args.feature_type}_{cfg.name}.pkl')
    with open(pred_path, 'rb') as f:
        output_dict = pickle.load(f)
    submission = ws.submission_path(create=True)

    results = {}
    if 'target' in output_dict:
        at = [0.3] * CLASSES_NUM
        if args.at_thresholds:
            with open(os.path.join(
                    ws.dir('opt_thresholds'),
                    f'best_{args.feature_type}_{cfg.name}.at.pkl'),
                    'rb') as f:
                at = pickle.load(f)['audio_tagging_threshold']
        precision, recall, f1 = calculate_precision_recall_f1(
            output_dict['target'], output_dict['clipwise_output'],
            thresholds=at)
        print('Clipwise micro precision: {:.3f}'.format(precision))
        print('Clipwise micro recall: {:.3f}'.format(recall))
        print('Clipwise micro F1: {:.3f}'.format(f1))
        results['clipwise'] = {'precision': precision, 'recall': recall,
                               'f1': f1}

    sed_params = common.load_sed_params(args, cfg, ws, EVAL_SED_PARAMS)
    event_list = post_events.frame_prediction_to_event_prediction(
        output_dict, sed_params, cfg.frames_per_second)
    post_events.write_submission(event_list, submission)
    sed_results = segment_metrics.official_evaluate(reference_csv_path,
                                                    submission)
    print('SED micro precision: {:.3f}'.format(
        get_metric(sed_results, 'precision')))
    print('SED micro recall: {:.3f}'.format(
        get_metric(sed_results, 'recall')))
    print('SED micro F1: {:.3f}'.format(get_metric(sed_results, 'f1')))
    print('SED micro ER: {:.3f}'.format(get_metric(sed_results, 'er')))
    results['sed'] = sed_results
    return results


def get_parser():
    parser = argparse.ArgumentParser(description='sed_tpu_torch metrics')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    sub = subparsers.add_parser('calculate_metrics')
    common.add_common_args(sub)
    sub.add_argument('--data_type', type=str, default='test',
                     choices=['test', 'evaluate'])
    sub.add_argument('--at_thresholds', action='store_true', default=False)
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    calculate_metrics(args)


if __name__ == '__main__':
    main()
