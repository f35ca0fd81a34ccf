"""Prediction CLI: audio files -> event XML (counterpart of
``sed_tpu/cli/predict.py``, ``predict`` mode).

Every file in ``--input_dir`` is decoded, sliding-window inferred with
framewise-averaged merging, event-decoded and written as
``<workspace>/predict_results/<name>.xml``.  ``--bulk N`` batches the
windows of N files into shared forwards; the XML is the same.

    python -m sed_tpu_torch.cli.predict predict --workspace WS \\
        --input_dir DIR --audio_16k --overlap \\
        --checkpoint tools/bench_checkpoint.npz --device cuda

``--device`` must be stated.  ``--checkpoint`` takes a ``sed_tpu`` .npz
checkpoint.
"""

from __future__ import annotations

import argparse
import os
import time

from sed_tpu_torch._host import cli_common, config


def _build_engine(args, cfg, ws):
    from sed_tpu_torch.compat.from_flax import load_npz
    from sed_tpu_torch.serve.engine import SedInferenceEngine, disable_tf32
    if args.checkpoint is None or not args.checkpoint.endswith('.npz'):
        raise SystemExit('--checkpoint must name a sed_tpu .npz checkpoint '
                         '(Orbax directories, .pth files and random init '
                         'are not supported by this port yet)')
    if args.feature_type != 'logmel':
        raise SystemExit(f'--feature_type {args.feature_type}: only logmel '
                         'is ported')
    disable_tf32()
    model = load_npz(args.checkpoint, args.model_type, cfg, args.device)
    sed_params = cli_common.load_sed_params(args, cfg, ws,
                                            config.PREDICT_SED_PARAMS)
    return SedInferenceEngine(
        model, cfg, args.device, sample_duration=args.sample_duration,
        overlap=args.overlap, overlap_value=args.overlap_value,
        sed_params=sed_params, batch_size=args.batch_size)


def _write_xml(out_dir: str, name: str, xml: str) -> None:
    stem = os.path.splitext(name)[0]
    with open(os.path.join(out_dir, stem + '.xml'), 'w') as f:
        f.write(xml)


def _predict_bulk(args, engine, out_dir, audio_files):
    """Batch the windows of ``--bulk`` files into shared forwards
    (``engine.predict_waveforms``); same events and XML as one file at a
    time."""
    from sed_tpu_torch._host import audio_io, xml_writer
    sr = engine.cfg.sample_rate
    for g0 in range(0, len(audio_files), args.bulk):
        chunk = audio_files[g0:g0 + args.bulk]
        t0 = time.time()
        waves = [audio_io.load_audio(p, sr=sr)[0] for p in chunk]
        names = [os.path.basename(p) for p in chunk]
        per_file = {n: [] for n in names}
        for e in engine.predict_waveforms(waves, names):
            per_file[e['filename']].append(e)
        for name, audio in zip(names, waves):
            xml = xml_writer.events_to_xml(
                sorted(per_file[name], key=lambda e: e['onset']), name,
                fallback_span=engine.fallback_span(len(audio) / float(sr)))
            _write_xml(out_dir, name, xml)
        print('Processed {} files in {:.2f} s'.format(
            len(chunk), time.time() - t0))
    return audio_files


def predict(args):
    cfg, ws = cli_common.resolve(args)
    engine = _build_engine(args, cfg, ws)
    out_dir = ws.predict_results_dir(create=True)
    audio_files = sorted(
        os.path.join(args.input_dir, f)
        for f in os.listdir(args.input_dir)
        if not f.startswith('.'))
    if args.bulk:
        return _predict_bulk(args, engine, out_dir, audio_files)
    for path in audio_files:
        print('Predicting on {}'.format(path))
        t0 = time.time()
        events, xml = engine.predict_file(path)
        for event in events:
            print('onset: {}, offset: {}, event_label: {}\n'.format(
                event['onset'], event['offset'], event['event_label']))
        _write_xml(out_dir, os.path.basename(path), xml)
        print('Time taken to process {}: {} s\n'.format(
            path, time.time() - t0))
    return audio_files


def get_parser():
    parser = argparse.ArgumentParser(description='sed_tpu_torch predict')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    sub = subparsers.add_parser('predict')
    cli_common.add_common_args(sub, require_dataset=False)
    sub.add_argument('--input_dir', type=str, required=True)
    sub.add_argument('--overlap', action='store_true', default=False)
    sub.add_argument('--sample_duration', type=int, default=5)
    sub.add_argument('--overlap_value', type=float, default=1.0)
    sub.add_argument('--checkpoint', type=str, default=None,
                     help='sed_tpu .npz checkpoint (required)')
    sub.add_argument('--device', type=str, required=True,
                     help="torch device to run on, e.g. 'cuda' or 'cpu'")
    sub.add_argument('--bulk', type=int, default=0,
                     help='batch the windows of this many files into '
                          'shared forwards (0 = one file at a time)')
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    predict(args)


if __name__ == '__main__':
    main()
