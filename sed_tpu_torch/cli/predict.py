"""Prediction CLI: audio files -> event XML (counterpart of
``sed_tpu/cli/predict.py``).

``predict``: every file in ``--input_dir`` is decoded, sliding-window
inferred with framewise-averaged merging, event-decoded and written as
``<workspace>/predict_results/<name>.xml``.  ``--bulk N`` batches the
windows of N files into shared forwards; the XML is the same.
``--resident`` serves a directory of uniform ``--sample_duration`` clips
in one wire format (int16, mu-law or IMA ADPCM wav, ``.q4/.q5/.q6``
containers; sniffed from the first file by ``audio_io.wire_reader_for``)
through ``SedInferenceEngine.predict_files_resident``: ``--upload_threads``
threads read the files into one pinned buffer, uploaded at once, and
``--max_pass_clips`` bounds the clips of one pass.

``predict_asr``: ``predict`` plus a transcript of each speech event, in a
``text=`` attribute of its XML element; needs the optional
``speech_recognition`` package (which calls Google's recogniser over the
network) and ffmpeg, which cuts each event's span from its file.

    python -m sed_tpu_torch.cli.predict predict --workspace WS \\
        --input_dir DIR --audio_16k --overlap \\
        --checkpoint tools/bench_checkpoint.npz --device cuda

``--device`` defaults to ``cuda`` (``--device cpu`` asks for the CPU).
``--checkpoint`` takes a ``sed_tpu`` .npz
or a reference .pth checkpoint; without it the workspace's
``best_<feature>_<quality>.pth`` is read.  ``--sed_thresholds`` reads the
pickle that ``optimize_thresholds optimize_sed_thresholds`` wrote.
"""

from __future__ import annotations

import argparse
import os
import time

from sed_tpu_torch import config
from sed_tpu_torch.cli import common


def _build_engine(args, cfg, ws):
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    model = common.build_model(args, cfg, ws)
    sed_params = common.load_sed_params(args, cfg, ws,
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
    from sed_tpu_torch.data import audio_io
    from sed_tpu_torch.post import xml_writer
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


def _predict_resident(args, engine, out_dir, audio_files):
    """Serve a uniform fixed-length clip corpus through the engine's
    resident pass (``predict_files_resident``).  Clips must all decode to
    ``--sample_duration`` seconds in the same wire format (int16, mu-law
    or IMA ADPCM wav, or a ``.qN`` container, sniffed from the first
    file)."""
    from sed_tpu_torch.data import audio_io
    if not audio_files:
        print('No audio files in --input_dir; nothing to do.')
        return audio_files
    if args.max_pass_clips < 0:
        raise SystemExit('--max_pass_clips must be >= 0 '
                         '(0 = whole corpus in one pass)')
    reader = audio_io.wire_reader_for(audio_files[0])
    names = [os.path.basename(p) for p in audio_files]
    t0 = time.time()
    telemetry = {}
    events, xmls = engine.predict_files_resident(
        audio_files, reader, names=names,
        upload_threads=args.upload_threads,
        max_pass_clips=args.max_pass_clips or None,
        telemetry=telemetry)
    for name, xml in zip(names, xmls):
        _write_xml(out_dir, name, xml)
    print('Processed {} clips in {:.2f} s ({} events); telemetry: {}'
          .format(len(audio_files), time.time() - t0,
                  sum(len(e) for e in events), telemetry))
    return audio_files


def _input_files(args):
    return sorted(os.path.join(args.input_dir, f)
                  for f in os.listdir(args.input_dir)
                  if not f.startswith('.'))


def predict(args):
    common.refuse_features(args, 'predict')
    cfg, ws = common.resolve(args)
    engine = _build_engine(args, cfg, ws)
    out_dir = ws.predict_results_dir(create=True)
    audio_files = _input_files(args)
    if args.resident:
        return _predict_resident(args, engine, out_dir, audio_files)
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


def predict_asr(args):
    """``predict`` + a transcript of each speech event
    (``pytorch/predict.py:410-677``).  Requires the optional
    ``speech_recognition`` package and ffmpeg; events in speech classes
    get a ``text=`` attribute in the XML."""
    try:
        import speech_recognition as sr  # optional dependency
    except ImportError as exc:
        raise SystemExit(
            'predict_asr requires the optional speech_recognition '
            'package: ' + str(exc))
    import subprocess
    import tempfile

    from sed_tpu_torch.post.xml_writer import events_to_xml
    common.refuse_features(args, 'predict_asr')
    cfg, ws = common.resolve(args)
    engine = _build_engine(args, cfg, ws)
    out_dir = ws.predict_results_dir(create=True)
    recognizer = sr.Recognizer()
    audio_files = _input_files(args)
    for path in audio_files:
        events, _ = engine.predict_file(path)
        for event in events:
            if event['event_label'] in config.SPEECH_LABELS:
                with tempfile.NamedTemporaryFile(suffix='.wav') as tmp:
                    subprocess.run(
                        ['ffmpeg', '-y', '-i', path,
                         '-ss', str(event['onset']),
                         '-to', str(event['offset']),
                         '-ar', '16000', tmp.name],
                        check=True, stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL)
                    try:
                        with sr.AudioFile(tmp.name) as source:
                            audio_data = recognizer.record(source)
                        event['text'] = recognizer.recognize_google(
                            audio_data, language=args.asr_language)
                    except (sr.UnknownValueError, sr.RequestError):
                        pass
        name = os.path.basename(path)
        _write_xml(out_dir, name, events_to_xml(events, name))
    return audio_files


def get_parser():
    parser = argparse.ArgumentParser(description='sed_tpu_torch predict')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    for mode in ('predict', 'predict_asr'):
        sub = subparsers.add_parser(mode)
        common.add_common_args(sub, require_dataset=False)
        sub.add_argument('--input_dir', type=str, required=True)
        sub.add_argument('--overlap', action='store_true', default=False)
        sub.add_argument('--sample_duration', type=int, default=5)
        sub.add_argument('--overlap_value', type=float, default=1.0)
        common.add_model_args(sub)
        if mode == 'predict':
            sub.add_argument('--bulk', type=int, default=0,
                             help='batch the windows of this many files '
                                  'into shared forwards (0 = one file at '
                                  'a time)')
            sub.add_argument('--resident', action='store_true',
                             default=False,
                             help='serve a uniform fixed-length clip '
                                  'corpus in one resident pass (one '
                                  'upload, every batch on the device, one '
                                  'pull); all files must be '
                                  '--sample_duration clips in one wire '
                                  'format')
            sub.add_argument('--upload_threads', type=int, default=4,
                             help='threads reading the --resident files '
                                  'into the pass buffer')
            sub.add_argument('--max_pass_clips', type=int, default=0,
                             help='bound device memory for --resident: '
                                  'serve at most this many clips per '
                                  'pass (0 = whole corpus in one pass)')
        else:
            sub.add_argument('--asr_language', type=str, default='en-SG')
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.mode == 'predict':
        predict(args)
    else:
        predict_asr(args)


if __name__ == '__main__':
    main()
