"""Closed-loop clip serving through ``SedInferenceEngine.predict_clips``.

One client sends a request, waits for its events and XML, and sends the
next.  Each request is ``request_clips`` int16 clips of ``clip_seconds``
s, one part of a seeded permutation of a pool of distinct clips, served
at ``batch_size`` clips a forward: the wire decode, the log-mel kernel,
the forward, coverage and track max on the card, then the threshold
masks pulled, the host decode and the XML.

End-to-end: ``clips_per_s``, every clip served in the window over the
whole window; ``request_p95_ms``, the 95th percentile of every request's
wall time.  Correctness, over a seeded sample of the requests the
window finished: the framewise output as the timed path produced it
against the plain reference's, and each clip's served events and XML
against the reference decoder's on that output.  With ``--trace 1`` a
traced segment of ``traced_requests`` requests follows the window.
"""

from __future__ import annotations

import time

import numpy as np

from bench_h100 import common, generate
from bench_h100.harness import Run
from bench_h100.reference import decode
from bench_h100.trace import Trace


def _requests(ctx):
    tr, cfg = ctx.traffic, ctx.config
    sr = cfg['audio']['sample_rate']
    clips, _ = generate.make_clips(tr['pool_clips'], sr, tr['clip_seconds'],
                                   ctx.seed, cfg['classes'],
                                   tr['events_per_clip'])
    pcm = generate.to_int16(clips)
    return [np.ascontiguousarray(pcm[rows]) for rows in generate.request_rows(
        tr['pool_clips'], tr['request_clips'], ctx.seed)]


def run(ctx) -> Run:
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(cfg, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = common.engine(ctx, tensors)
    requests = _requests(ctx)
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
                    'clip_samples': requests[0].shape[1]})
    if ctx.trace:
        _traced(ctx, engine, requests, run, fused_logmel)
    run.memory_peak_bytes = common.peak_memory(dev)
    capture.close()
    del engine
    common.free(dev)
    checked = sorted(k for k in capture.kept if k in served)
    run.checks = check(ctx, tensors, requests, {
        k: (k % len(requests), capture.framewise(k), served[k])
        for k in checked})
    return run


def _traced(ctx, engine, requests, run, fused_logmel) -> None:
    """``traced_requests`` requests under the profiler, after one unmarked
    warm request; spans around the temporal block's forwards."""
    temporal = getattr(engine.model, ctx.config['temporal'])
    handles = common.hook_spans(temporal, 'temporal')
    n = ctx.traffic['traced_requests']
    out = {}
    with common.profiled(ctx.device, out):
        engine.predict_clips(requests[0])
        common.sync(ctx.device)
        launches = fused_logmel.launches
        with common.marker():
            for k in range(n):
                with common.span('request'):
                    engine.predict_clips(requests[k % len(requests)])
            common.sync(ctx.device)
        launches = fused_logmel.launches - launches
    for h in handles:
        h.remove()
    run.trace = Trace(out['prof'])
    run.counters['fused_logmel.launches'] = launches
    run.info['traced_clips'] = sum(len(requests[k % len(requests)])
                                   for k in range(n))


def check(ctx, tensors: dict, requests: list, checked: dict) -> list:
    """``framewise_err``: the largest |program - plain reference (float32)|
    framewise probability over the checked requests.  ``decode_errors``:
    the checked clips whose served events or XML differ from the
    reference decoder's on the program's own framewise output, divided by
    the reference's coverage of one clip (an exact comparison)."""
    import torch
    tr, cfg = ctx.traffic, ctx.config
    limits = ctx.cell.spec['limits']
    if not checked:
        return [('framewise_err', float('inf'), limits['framewise_err']),
                ('decode_errors', float('inf'), limits['decode_errors'])]
    ref = reference_framewise(ctx, tensors, requests,
                              sorted({r for r, _, _ in checked.values()}))
    fps = cfg['audio']['sample_rate'] // cfg['audio']['hop_size']
    err, wrong = 0.0, 0
    for r, fw, (events, xmls) in checked.values():
        err = max(err, float((fw - ref[r]).abs().max()))
        coverage = torch.from_numpy(decode.coverage(
            fw.shape[1], tr['clip_seconds'], fps)).to(fw)
        probs = (fw / coverage[None, :, None]).cpu().numpy()
        for j, (evs, doc) in enumerate(zip(events, xmls)):
            want = decode.events(probs[j], cfg['classes'])
            if sorted(decode.as_tuples(evs)) != sorted(want) or \
                    doc != decode.xml(want, f'clip{j}.wav',
                                      (0, tr['clip_seconds'])):
                wrong += 1
    return [('framewise_err', err, limits['framewise_err']),
            ('decode_errors', wrong, limits['decode_errors'])]


def reference_framewise(ctx, tensors: dict, requests: list, which: list,
                        dtype=None) -> dict:
    """{request: (clips, T, C) framewise probabilities on the card} of the
    plain reference, a batch at a time (``dtype``: its compute dtype)."""
    import torch
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    dtype = dtype or torch.float32
    params = {k: v.to(dtype) for k, v in tensors.items()}
    out = {}
    with torch.no_grad():
        for r in which:
            parts = []
            for i in range(0, len(requests[r]), tr['batch_size']):
                wav = torch.from_numpy(requests[r][i:i + tr['batch_size']]) \
                    .to(dev).float() / tr['int16_scale']
                parts.append(ctx.cell.reference.reference(
                    params, wav, cfg, dtype=dtype)[0])
            out[r] = torch.cat(parts)
    return out


def control(ctx) -> dict:
    """The readings that set the limit of ``framewise_err``, for one seed
    at the cell's own size: the program's (sound runs) over every request
    of the pool, served as the window serves them, and the control's (the
    plain reference in bfloat16 in the program's place)."""
    import torch
    tr, dev = ctx.traffic, ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(ctx.config, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = common.engine(ctx, tensors)
    requests = _requests(ctx)
    every = list(range(len(requests)))
    capture = common.Capture(engine.model, every)
    served = {}
    for k in every:
        capture.now = k
        served[k] = engine.predict_clips(requests[k])
    capture.close()
    del engine
    common.free(dev)
    checks = dict((n, v) for n, v, _ in check(
        ctx, tensors, requests,
        {k: (k, capture.framewise(k), served[k]) for k in every}))
    ref = reference_framewise(ctx, tensors, requests, every)
    low = reference_framewise(ctx, tensors, requests, every, torch.bfloat16)
    events = sum(len(e) for evs, _ in served.values() for e in evs)
    return {'program': checks['framewise_err'],
            'program.decode_errors': checks['decode_errors'],
            'control': max(float((low[r] - ref[r]).abs().max())
                           for r in every),
            'events_per_clip': events / sum(len(q) for q in requests)}
