"""Test-set inference and metrics CLI (counterpart of
``sed_tpu/cli/main_strong.py``'s inference modes).

    python -m sed_tpu_torch.cli.main_strong inference_prob_overlap \\
        --dataset_dir DS --workspace WS --audio_16k --device cuda

Modes, each on the packed test split (``sed_tpu.cli.features``):

* ``inference_prob``: one forward per 10 s clip (``Evaluator``), the
  submission CSV, micro P/R/F1/ER, and the ``test_predictions_*.pkl``
  pickle for offline threshold tuning;
* ``inference_prob_overlap``: overlapped windows merged by framewise
  averaging on the device (``predict_clips_windowed``), for each
  [overlap_value, window] of ``PARAM_COMBINATIONS``;
* ``inference_prob_vote``: per-window binarisation and vote counts.

The model comes from ``--checkpoint`` (.npz or .pth) or the workspace's
``.pth``; ``--device`` defaults to ``cuda``.  ``train`` is not ported yet.
"""

from __future__ import annotations

import argparse
import pickle
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


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='sed_tpu_torch main_strong')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    common.add_common_args(subparsers.add_parser('train'))
    for mode in ('inference_prob', 'inference_prob_overlap',
                 'inference_prob_vote'):
        sub = subparsers.add_parser(mode)
        common.add_common_args(sub)
        common.add_model_args(sub)
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.mode == 'train':
        raise SystemExit('main_strong train is not ported to sed_tpu_torch '
                         'yet (ROADMAP queue 1 item 9): train with '
                         'sed_tpu.cli.main_strong')
    return {'inference_prob': inference_prob,
            'inference_prob_overlap': inference_prob_overlap,
            'inference_prob_vote': inference_prob_vote}[args.mode](args)


if __name__ == '__main__':
    main()
