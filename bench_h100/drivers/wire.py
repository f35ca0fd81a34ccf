"""Closed-loop clip serving through ``SedInferenceEngine.predict_clips``
with the clips sent in a compressed uint8 wire (``wire`` in the
traffic: ``adpcm4``, IMA ADPCM at 4 bits a sample).

As ``serve.py``'s traffic, one client and requests of ``request_clips``
clips from a seeded permutation of a pool of distinct clips, except that
each int16 clip is encoded once at set-up, outside the timed window, by
the program's host encoder (``audio_io.adpcm_encode_np``: encoding is the
client's work), and the program is sent the uint8 rows: the upload, the
wire decode on the card (``ops/wire._adpcm_decode``, one launch of
``csrc/adpcm_decode.cu`` a batch), log-mel, the forward, then the host
decode and the XML.

End-to-end: ``clips_per_s`` and ``request_p95_ms`` as ``serve.py``'s.
Correctness as ``serve.py``'s ``check``, with the plain reference given
the rows as the plain decoder (``reference/adpcm.py``) decodes them:
the framewise output as the timed path produced it against the
reference's, and each checked clip's events and XML against the
reference decoder's.  With ``--trace 1`` a traced segment of
``traced_requests`` requests follows the window; a segment whose trace
holds other log-mel or ADPCM launches than the program counted is taken
again.
"""

from __future__ import annotations

import dataclasses
import time

from bench_h100 import common
from bench_h100.drivers import serve
from bench_h100.harness import Run
from bench_h100.reference import adpcm
from bench_h100.trace import Trace

TRACE_ATTEMPTS = 3


def _wire(ctx, requests: list) -> list:
    """Each request's int16 rows in the traffic's wire, by the program's
    host encoder."""
    from sed_tpu_torch.data import audio_io
    if ctx.traffic['wire'] != 'adpcm4':
        raise ValueError(f'no encoder for the wire {ctx.traffic["wire"]}')
    return [audio_io.adpcm_encode_np(r) for r in requests]


def _decoded(ctx, wire: list, which) -> dict:
    """{request: (clips, samples) float32} of the plain decoder."""
    samples = ctx.config['audio']['sample_rate'] * ctx.traffic['clip_seconds']
    return {r: adpcm.decode(wire[r], samples) for r in which}


def _as_decoded(ctx):
    """``ctx`` with the traffic's int16 scale at 1: ``serve``'s reference
    side then takes the decoded float32 rows as they are."""
    cell = dataclasses.replace(ctx.cell,
                               traffic=dict(ctx.traffic, int16_scale=1))
    return dataclasses.replace(ctx, cell=cell)


def run(ctx) -> Run:
    from sed_tpu_torch.ops import wire as wire_ops
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(cfg, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = common.engine(ctx, tensors)
    requests = _wire(ctx, serve._requests(ctx))
    engine.warmup(requests[0][:tr['batch_size']])
    for r in requests[:tr['warm_requests']]:
        engine.predict_clips(r)
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
            served[k] = engine.predict_clips(requests[k % len(requests)])
        except Exception as e:          # counted, and the run not correct
            failed += 1
            ctx.log(f'request {k} failed: {e!r}')
        b = time.perf_counter()
        latencies.append(b - a)
        k += 1
        if b >= window.deadline:
            break
    capture.now = None
    wall = b - window.t0
    clips = sum(len(requests[i % len(requests)]) for i in served)
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
                    'clip_samples': cfg['audio']['sample_rate']
                    * tr['clip_seconds'],
                    'wire': tr['wire'], 'wire_bytes': requests[0].shape[1]})
    if ctx.trace:
        _traced(ctx, engine, requests, run,
                {'fused_logmel.launches': (fused_logmel, 'logmel'),
                 '_adpcm_decode.launches': (wire_ops._adpcm_decode,
                                            'adpcm_decode')})
    run.memory_peak_bytes = common.peak_memory(dev)
    capture.close()
    del engine
    common.free(dev)
    checked = sorted(k for k in capture.kept if k in served)
    decoded = _decoded(ctx, requests,
                       sorted({k % len(requests) for k in checked}))
    run.checks = serve.check(
        _as_decoded(ctx), tensors, [decoded.get(r) for r in
                                    range(len(requests))],
        {k: (k % len(requests), capture.framewise(k), served[k])
         for k in checked})
    return run


def _traced(ctx, engine, requests, run, counted: dict) -> None:
    """``traced_requests`` requests under the profiler, after one unmarked
    warm request; spans around the temporal block's forwards.  ``counted``:
    {counter name: (the program's counted function, a part of its
    kernel's name)}; a segment whose trace holds another number of a
    kernel's launches than its counter is taken again, up to
    ``TRACE_ATTEMPTS`` times (the profiler can lose a kernel)."""
    temporal = getattr(engine.model, ctx.config['temporal'])
    handles = common.hook_spans(temporal, 'temporal')
    n = ctx.traffic['traced_requests']
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        out = {}
        with common.profiled(ctx.device, out):
            engine.predict_clips(requests[0])
            common.sync(ctx.device)
            before = {k: fn.launches for k, (fn, _) in counted.items()}
            with common.marker():
                for k in range(n):
                    with common.span('request'):
                        engine.predict_clips(requests[k % len(requests)])
                common.sync(ctx.device)
            launches = {k: fn.launches - before[k]
                        for k, (fn, _) in counted.items()}
        trace = Trace(out['prof'])
        lost = {k: (trace.kernel_us(part)[1], launches[k])
                for k, (_, part) in counted.items()
                if trace.kernel_us(part)[1] != launches[k]}
        if not lost or attempt == TRACE_ATTEMPTS:
            break
        ctx.log(f'traced segment {attempt}: (traced, counted) launches '
                f'{lost}; taken again')
    for h in handles:
        h.remove()
    run.trace = trace
    run.counters.update(launches)
    run.info['traced_clips'] = sum(len(requests[k % len(requests)])
                                   for k in range(n))


def control(ctx) -> dict:
    """The readings that set the limit of ``framewise_err``, for one seed
    at the cell's own size: the program's (sound runs) over every request
    of the pool, served in the wire as the window serves them, and the
    control's (the plain reference in bfloat16 in the program's place),
    both against the plain reference on the plainly decoded rows."""
    import torch
    dev = ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(ctx.config, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = common.engine(ctx, tensors)
    requests = _wire(ctx, serve._requests(ctx))
    every = list(range(len(requests)))
    capture = common.Capture(engine.model, every)
    served = {}
    for k in every:
        capture.now = k
        served[k] = engine.predict_clips(requests[k])
    capture.close()
    del engine
    common.free(dev)
    view = _as_decoded(ctx)
    decoded = _decoded(ctx, requests, every)
    rows = [decoded[r] for r in every]
    checks = dict((n, v) for n, v, _ in serve.check(
        view, tensors, rows,
        {k: (k, capture.framewise(k), served[k]) for k in every}))
    ref = serve.reference_framewise(view, tensors, rows, every)
    low = serve.reference_framewise(view, tensors, rows, every,
                                    torch.bfloat16)
    events = sum(len(e) for evs, _ in served.values() for e in evs)
    return {'program': checks['framewise_err'],
            'program.decode_errors': checks['decode_errors'],
            'control': max(float((low[r] - ref[r]).abs().max())
                           for r in every),
            'events_per_clip': events / sum(len(q) for q in requests)}
