"""Live streams through ``serve/streaming.StreamingSed``.

One stream at a time: ``clips_per_stream`` distinct pool clips of
``clip_seconds`` s joined into one float32 stream, fed in chunks of
``chunk_seconds`` as fast as ``feed`` returns, then ``flush``; then the
next stream.  Each feed that completes a window runs a batch-1 forward
(``infer_framewise``), overlap-adds it on the host, and re-decodes the
whole finalised prefix to emit the events no later audio can change.

End-to-end: ``feed_p95_ms``, the 95th percentile of every ``feed`` and
``flush`` call in the window (the delay each call adds to the events it
emits).  Correctness, over a seeded sample of the streams the window
finished: each window's framewise output as the timed path produced it
against the plain reference's, and the union of the events the stream
emitted against the reference's offline decode (every window
overlap-added, divided by the coverage, decoded) of the program's own
window outputs: they must be equal.  With ``--trace 1`` one stream is
traced after the window.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from bench_h100 import common, generate
from bench_h100.harness import Run
from bench_h100.reference import decode
from bench_h100.trace import Trace


def _streams(ctx) -> list:
    tr, cfg = ctx.traffic, ctx.config
    clips, _ = generate.make_clips(tr['pool_clips'],
                                   cfg['audio']['sample_rate'],
                                   tr['clip_seconds'], ctx.seed,
                                   cfg['classes'], tr['events_per_clip'])
    return [np.ascontiguousarray(clips[rows].reshape(-1))
            for rows in generate.stream_clips(
                tr['pool_clips'], tr['clips_per_stream'], tr['streams'],
                ctx.seed)]


def serve_stream(engine, audio: np.ndarray, chunk: int, times=None) -> list:
    """Feed one stream chunk by chunk and flush it; the emitted events
    as (label, onset, offset).  ``times`` gets each call's seconds."""
    from sed_tpu_torch.serve.streaming import StreamingSed
    live = StreamingSed(engine)
    out = []
    calls = [lambda i=i: live.feed(audio[i:i + chunk])
             for i in range(0, len(audio), chunk)] + [live.flush]
    for call in calls:
        a = time.perf_counter()
        out += call()
        if times is not None:
            times.append(time.perf_counter() - a)
    return decode.as_tuples(out)


def run(ctx) -> Run:
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(cfg, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = common.engine(ctx, tensors)
    streams = _streams(ctx)
    chunk = int(tr['chunk_seconds'] * cfg['audio']['sample_rate'])
    for s in streams[:tr['warm_streams']]:
        serve_stream(engine, s, chunk)
    capture = common.Capture(engine.model, common.sample(
        tr['checked_within'], tr['checked_streams'], ctx.seed, 0x57C4))
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    times, served, failed = [], {}, 0
    # the window is Python on the host: the set-up's objects (the imports,
    # the model, the streams) leave the collector's scans, so that each
    # collection in the window scans only what the window made
    gc.collect()
    gc.freeze()
    window = common.Window(ctx.seconds)
    k = 0
    while not window.done():
        capture.now = k
        try:
            served[k] = serve_stream(engine, streams[k % len(streams)],
                                     chunk, times)
        except Exception as e:          # counted, and the run not correct
            failed += 1
            ctx.log(f'stream {k} failed: {e!r}')
        k += 1
    capture.now = None
    wall = time.perf_counter() - window.t0
    gc.unfreeze()
    ctx.log(f'window {wall:.3f} s: {k} streams, {len(times)} calls, '
            f'setup {setup_s:.3f} s')
    if k:
        # where in its stream each call at or above the 95th percentile
        # fell (every stream makes the same calls)
        pos = np.flatnonzero(np.asarray(times) >= np.percentile(times, 95)) \
            % (len(times) // k)
        ctx.log(f'calls at or above p95: {len(pos)}, at stream positions '
                f'{np.percentile(pos, [0, 25, 50, 75, 100]).tolist()} of '
                f'{len(times) // k}')
    run = Run(attempted=k, failed=failed,
              end_to_end={'feed_p95_ms': common.p95(times) * 1e3,
                          'setup_s': setup_s},
              checks=[], memory_peak_bytes=None,
              info={'kind': 'stream', 'config': cfg, 'window_s': wall,
                    'calls': len(times)})
    if ctx.trace:
        out = {}
        with common.profiled(dev, out):
            serve_stream(engine, streams[0][:10 * chunk], chunk)
            common.sync(dev)
            with common.marker():
                with common.span('stream'):
                    serve_stream(engine, streams[0], chunk)
                common.sync(dev)
        run.trace = Trace(out['prof'])
    run.memory_peak_bytes = common.peak_memory(dev)
    capture.close()
    del engine
    common.free(dev)
    run.checks = check(ctx, tensors, streams, {
        k: (k % len(streams), capture.framewise(k), served[k])
        for k in sorted(capture.kept) if k in served})
    return run


def merged(windows: np.ndarray, sample_duration: int, hop: int):
    """Overlap-add of (n, T, C) window outputs at ``hop`` frames, divided
    by the coverage: the offline pipeline's (T_total, C) probabilities."""
    t_win = windows.shape[1]
    total = t_win + (len(windows) - 1) * hop
    sums = np.zeros((total, windows.shape[2]), windows.dtype)
    for n, w in enumerate(windows):
        sums[n * hop:n * hop + t_win] += w
    return sums / decode.coverage(total, sample_duration, hop)[:, None]


def check(ctx, tensors: dict, streams: list, checked: dict) -> list:
    """``framewise_err``: the largest |program - plain reference (float32)|
    window output over the checked streams.  ``decode_errors``: the
    checked streams whose emitted events differ from the offline decode
    of the program's own window outputs (an exact comparison)."""
    tr, cfg = ctx.traffic, ctx.config
    limits = ctx.cell.spec['limits']
    if not checked:
        return [('framewise_err', float('inf'), limits['framewise_err']),
                ('decode_errors', float('inf'), limits['decode_errors'])]
    hop = cfg['audio']['sample_rate'] // cfg['audio']['hop_size']
    err, wrong = 0.0, 0
    for s, fw, got in checked.values():
        ref = reference_windows(ctx, tensors, streams[s])
        err = max(err, float((fw - ref).abs().max()))
        want = decode.events(merged(fw.cpu().numpy(), tr['clip_seconds'],
                                    hop), cfg['classes'])
        wrong += sorted(got) != sorted(want)
    return [('framewise_err', err, limits['framewise_err']),
            ('decode_errors', wrong, limits['decode_errors'])]


def reference_windows(ctx, tensors: dict, audio: np.ndarray, dtype=None):
    """(n, T, C) framewise outputs of the plain reference for every window
    of a stream's 1 s grid, on the card."""
    import torch
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    dtype = dtype or torch.float32
    sr = cfg['audio']['sample_rate']
    width = tr['clip_seconds'] * sr
    starts = range(0, len(audio) // sr - tr['clip_seconds'] + 1)
    params = {k: v.to(dtype) for k, v in tensors.items()}
    parts = []
    with torch.no_grad():
        for i in range(0, len(starts), tr['batch_size']):
            wav = torch.from_numpy(np.stack([
                audio[s * sr:s * sr + width]
                for s in starts[i:i + tr['batch_size']]])).to(dev)
            parts.append(ctx.cell.reference.reference(params, wav, cfg,
                                                      dtype=dtype)[0])
    return torch.cat(parts)


def control(ctx) -> dict:
    """The readings that set the limit of ``framewise_err``, for one seed
    at the cell's own size, over ``checked_streams`` streams: the
    program's (sound runs) and the control's, the plain reference in
    bfloat16 in the program's place."""
    import torch
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(cfg, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = common.engine(ctx, tensors)
    streams = _streams(ctx)[:tr['checked_streams']]
    chunk = int(tr['chunk_seconds'] * cfg['audio']['sample_rate'])
    capture = common.Capture(engine.model, range(len(streams)))
    served = {}
    for k, s in enumerate(streams):
        capture.now = k
        served[k] = serve_stream(engine, s, chunk)
    capture.close()
    del engine
    common.free(dev)
    checks = dict((n, v) for n, v, _ in check(
        ctx, tensors, streams,
        {k: (k, capture.framewise(k), served[k]) for k in served}))
    ctl = max(float((reference_windows(ctx, tensors, s, torch.bfloat16)
                     - reference_windows(ctx, tensors, s)).abs().max())
              for s in streams)
    return {'program': checks['framewise_err'],
            'program.decode_errors': checks['decode_errors'],
            'control': ctl,
            'events_per_stream': sum(map(len, served.values()))
            / len(streams)}
