"""Closed-loop serving of wav files through
``SedInferenceEngine.predict_files_resident``, the path of the CLI's
``predict --resident``.

As ``serve.py``'s traffic, one client and requests of ``request_clips``
clips from a seeded permutation of a pool of distinct clips, except that
at set-up each int16 clip of the pool is written once as a file
(``files`` in the traffic: ``wav_int16``, 16-bit PCM mono wav by the
standard library's ``wave``), and a request names its clips' files: the
program reads them with ``audio_io.wire_reader_for``'s reader in
``UPLOAD_THREADS`` threads straight into one pinned buffer
(``sed::serve.read``), uploads it once, and serves it at ``batch_size``
clips a forward, then the host decode and the XML.

The files are memory-backed (``os.memfd_create``) and named by their
``/proc/<pid>/fd/<fd>`` paths: page-cached files, as a server's local
disk holds files dropped on it moments before, with no file system of
the benchmark's machine between (where the checkout sits on a network
file system, its reads would time the network).  They go with the
process, or at the end of ``run``.

End-to-end: ``clips_per_s`` and ``request_p95_ms`` as ``serve.py``'s.
Correctness as ``serve.py``'s ``check``, with the plain reference given
the int16 rows as they were written, so that a reader that misreads a
file fails it.  With ``--trace 1`` a traced segment of
``traced_requests`` requests follows the window.
"""

from __future__ import annotations

import io
import os
import time
import wave

import numpy as np

from bench_h100 import common, generate
from bench_h100.drivers import serve
from bench_h100.harness import Run
from bench_h100.trace import Trace

UPLOAD_THREADS = 4      # the CLI's ``predict --resident`` default


class Files:
    """The pool's int16 rows as memory-backed wav files, one a row."""

    def __init__(self, pcm: np.ndarray, sample_rate: int):
        self.fds = []
        for j, row in enumerate(pcm):
            data = io.BytesIO()
            with wave.open(data, 'wb') as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sample_rate)
                w.writeframes(row.astype('<i2').tobytes())
            fd = os.memfd_create(f'clip{j}.wav')
            self.fds.append(fd)
            view = memoryview(data.getvalue())
            while view:
                view = view[os.write(fd, view):]
        self.paths = [f'/proc/{os.getpid()}/fd/{fd}' for fd in self.fds]

    def close(self) -> None:
        for fd in self.fds:
            os.close(fd)
        self.fds, self.paths = [], []


def _pool(ctx):
    """The pool's int16 rows, its files and each request's rows, in
    ``serve.py``'s order (the same seed gives the same clips)."""
    tr, cfg = ctx.traffic, ctx.config
    if tr['files'] != 'wav_int16':
        raise ValueError(f'no writer for the files {tr["files"]}')
    sr = cfg['audio']['sample_rate']
    clips, _ = generate.make_clips(tr['pool_clips'], sr, tr['clip_seconds'],
                                   ctx.seed, cfg['classes'],
                                   tr['events_per_clip'])
    pcm = generate.to_int16(clips)
    order = generate.request_rows(tr['pool_clips'], tr['request_clips'],
                                  ctx.seed)
    return pcm, Files(pcm, sr), order


def _server(engine, files: Files, order: list):
    """``serve_request(k)``: request ``k`` (cycling) served from its files
    by the CLI's resident path."""
    from sed_tpu_torch.data import audio_io
    reader = audio_io.wire_reader_for(files.paths[0])
    requests = [[files.paths[i] for i in rows] for rows in order]
    names = [[f'clip{j}.wav' for j in range(len(rows))] for rows in order]

    def serve_request(k: int):
        k %= len(requests)
        return engine.predict_files_resident(
            requests[k], reader, names=names[k],
            upload_threads=UPLOAD_THREADS)
    return serve_request


def run(ctx) -> Run:
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(cfg, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = common.engine(ctx, tensors)
    pcm, files, order = _pool(ctx)
    try:
        serve_request = _server(engine, files, order)
        engine.warmup(pcm[order[0][:tr['batch_size']]])
        for k in range(tr['warm_requests']):
            serve_request(k)
        capture = common.Capture(engine.model, common.sample(
            tr['checked_within'], tr['checked_requests'], ctx.seed, 0xC4EC))
        common.sync(dev)
        setup_s = time.perf_counter() - ctx.t_start

        latencies, served, failed = [], {}, 0
        window = common.Window(ctx.seconds)
        k = 0
        while True:
            a = time.perf_counter()
            capture.now = k
            try:
                served[k] = serve_request(k)
            except Exception as e:      # counted, and the run not correct
                failed += 1
                ctx.log(f'request {k} failed: {e!r}')
            b = time.perf_counter()
            latencies.append(b - a)
            k += 1
            if b >= window.deadline:
                break
        capture.now = None
        wall = b - window.t0
        clips = sum(len(order[i % len(order)]) for i in served)
        ctx.log(f'window {wall:.3f} s: {k} requests, {clips} clips, '
                f'setup {setup_s:.3f} s')
        run = Run(attempted=k, failed=failed,
                  end_to_end={'clips_per_s': clips / wall,
                              'request_p95_ms': common.p95(latencies) * 1e3,
                              'setup_s': setup_s},
                  checks=[], memory_peak_bytes=None,
                  info={'kind': 'serve', 'config': cfg,
                        'model': ctx.cell.reference, 'window_s': wall,
                        'clips': clips, 'batch_size': tr['batch_size'],
                        'clip_samples': pcm.shape[1], 'files': tr['files'],
                        'upload_threads': UPLOAD_THREADS})
        if ctx.trace:
            _traced(ctx, engine, serve_request, order, run, fused_logmel)
    finally:
        files.close()
    run.memory_peak_bytes = common.peak_memory(dev)
    capture.close()
    del engine
    common.free(dev)
    checked = sorted(k for k in capture.kept if k in served)
    run.checks = serve.check(
        ctx, tensors, [pcm[rows] for rows in order],
        {k: (k % len(order), capture.framewise(k), served[k])
         for k in checked})
    return run


def _traced(ctx, engine, serve_request, order, run, fused_logmel) -> None:
    """``traced_requests`` requests under the profiler, after one unmarked
    warm request; spans around the temporal block's forwards."""
    temporal = getattr(engine.model, ctx.config['temporal'])
    handles = common.hook_spans(temporal, 'temporal')
    n = ctx.traffic['traced_requests']
    out = {}
    with common.profiled(ctx.device, out):
        serve_request(0)
        common.sync(ctx.device)
        launches = fused_logmel.launches
        with common.marker():
            for k in range(n):
                with common.span('request'):
                    serve_request(k)
            common.sync(ctx.device)
        launches = fused_logmel.launches - launches
    for h in handles:
        h.remove()
    run.trace = Trace(out['prof'])
    run.counters['fused_logmel.launches'] = launches
    run.info['traced_clips'] = sum(len(order[k % len(order)])
                                   for k in range(n))


def control(ctx) -> dict:
    """The readings that set the limit of ``framewise_err``, for one seed
    at the cell's own size: the program's (sound runs) over every request
    of the pool, served from the files as the window serves them, and the
    control's (the plain reference in bfloat16 in the program's place)."""
    import torch
    dev = ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(ctx.config, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = common.engine(ctx, tensors)
    pcm, files, order = _pool(ctx)
    every = list(range(len(order)))
    capture = common.Capture(engine.model, every)
    served = {}
    try:
        serve_request = _server(engine, files, order)
        for k in every:
            capture.now = k
            served[k] = serve_request(k)
    finally:
        files.close()
    capture.close()
    del engine
    common.free(dev)
    rows = [pcm[r] for r in order]
    checks = dict((n, v) for n, v, _ in serve.check(
        ctx, tensors, rows,
        {k: (k, capture.framewise(k), served[k]) for k in every}))
    ref = serve.reference_framewise(ctx, tensors, rows, every)
    low = serve.reference_framewise(ctx, tensors, rows, every,
                                    torch.bfloat16)
    events = sum(len(e) for evs, _ in served.values() for e in evs)
    return {'program': checks['framewise_err'],
            'program.decode_errors': checks['decode_errors'],
            'control': max(float((low[r] - ref[r]).abs().max())
                           for r in every),
            'events_per_clip': events / sum(len(q) for q in order)}
