"""Closed-loop evaluation of whole clips through
``SedInferenceEngine.predict_clips_windowed`` (the ``inference_prob_overlap``
path): overlapped windows, merged on the card.

One client sends a request, waits for its events, and sends the next.
Each request is ``request_clips`` int16 clips of ``clip_seconds`` s, one
part of a seeded permutation of a pool of distinct clips.  The engine
runs windows of ``window_seconds`` s at ``step_seconds`` s steps (9 a
10 s clip at 6 s and 0.5 s), ``batch_size // windows`` clips a forward
(chunks of 3 clips, 27 windows, and a tail chunk of 1 clip, 9 windows,
for 64 clips at batch 32; both shapes are warmed in the set-up): the
wire decode, the window slicing, log-mel, the forward, the overlap-add
and the coverage division on the card, then the threshold masks pulled
and the host decode.

End-to-end: ``clips_per_s``, every clip served in the window over the
whole window; ``request_p95_ms``, the 95th percentile of every request's
wall time.  Correctness, over a seeded sample of the requests the
window finished: every window's framewise output as the timed path
produced it against the plain reference's windows, and each clip's
served events against the reference decoder's on this driver's own
overlap-add of those outputs, divided by the reference's coverage.
With ``--trace 1`` a traced segment of ``traced_requests`` requests
follows the window.
"""

from __future__ import annotations

import time

import numpy as np

from bench_h100 import common, generate
from bench_h100.harness import Run
from bench_h100.reference import decode
from bench_h100.trace import Trace


def _requests(ctx) -> list:
    tr, cfg = ctx.traffic, ctx.config
    clips, _ = generate.make_clips(tr['pool_clips'],
                                   cfg['audio']['sample_rate'],
                                   tr['clip_seconds'], ctx.seed,
                                   cfg['classes'], tr['events_per_clip'])
    pcm = generate.to_int16(clips)
    return [np.ascontiguousarray(pcm[rows]) for rows in generate.request_rows(
        tr['pool_clips'], tr['request_clips'], ctx.seed)]


def _engine(ctx, tensors: dict):
    """The program's engine at the traffic's window and batch."""
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    cfg = common.program_audio(ctx.config)
    model = ctx.cell.reference.program_model(ctx.config, tensors, cfg,
                                             ctx.device)
    return SedInferenceEngine(model, cfg, ctx.device,
                              sample_duration=ctx.traffic['window_seconds'],
                              batch_size=ctx.traffic['batch_size'])


def _serve(engine, ctx, rows: np.ndarray) -> list:
    """One request: each clip's events."""
    tr = ctx.traffic
    return engine.predict_clips_windowed(
        rows, [f'clip{j}.wav' for j in range(len(rows))],
        duration=tr['clip_seconds'], step=tr['step_seconds'])


def _starts(tr) -> list:
    """Window starts in seconds, as the reference's loop makes them."""
    starts, s = [0.0], tr['step_seconds']
    while s + tr['window_seconds'] <= tr['clip_seconds']:
        starts.append(s)
        s += tr['step_seconds']
    return starts


def run(ctx) -> Run:
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(cfg, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = _engine(ctx, tensors)
    requests = _requests(ctx)
    for r in requests[:tr['warm_requests']]:
        _serve(engine, ctx, r)
    capture = common.Capture(engine.model, common.sample(
        tr['checked_within'], tr['checked_requests'], ctx.seed, 0xE7A1))
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    latencies, served, failed = [], {}, 0
    window = common.Window(ctx.seconds)
    k = 0
    while True:
        a = time.perf_counter()
        capture.now = k
        try:
            served[k] = _serve(engine, ctx, requests[k % len(requests)])
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
    windows = clips * len(_starts(tr))
    ctx.log(f'window {wall:.3f} s: {k} requests, {clips} clips, {windows} '
            f'windows, setup {setup_s:.3f} s')
    run = Run(attempted=k, failed=failed,
              end_to_end={'clips_per_s': clips / wall,
                          'request_p95_ms': common.p95(latencies) * 1e3,
                          'setup_s': setup_s},
              checks=[], memory_peak_bytes=None,
              info={'kind': 'eval', 'config': cfg,
                    'model': ctx.cell.reference, 'window_s': wall,
                    'clips': clips, 'windows': windows,
                    'batch_size': tr['batch_size'],
                    'window_samples': engine.window_samples})
    if ctx.trace:
        _traced(ctx, engine, requests, run)
    run.memory_peak_bytes = common.peak_memory(dev)
    capture.close()
    del engine
    common.free(dev)
    checked = sorted(k for k in capture.kept if k in served)
    run.checks = check(ctx, tensors, requests, {
        k: (k % len(requests), capture.framewise(k), served[k])
        for k in checked})
    return run


def _traced(ctx, engine, requests, run) -> None:
    """``traced_requests`` requests under the profiler, after one unmarked
    warm request; spans around the temporal block's forwards."""
    temporal = getattr(engine.model, ctx.config['temporal'])
    handles = common.hook_spans(temporal, 'temporal')
    n = ctx.traffic['traced_requests']
    out = {}
    with common.profiled(ctx.device, out):
        _serve(engine, ctx, requests[0])
        common.sync(ctx.device)
        with common.marker():
            for k in range(n):
                with common.span('request'):
                    _serve(engine, ctx, requests[k % len(requests)])
            common.sync(ctx.device)
    for h in handles:
        h.remove()
    run.trace = Trace(out['prof'])
    run.info['traced_clips'] = sum(len(requests[k % len(requests)])
                                   for k in range(n))


def merged(windows, ctx):
    """(clips, T_total, C) on the windows' device: each clip's (W, T, C)
    window outputs added in window order at ``step_seconds`` offsets
    (float32, as a sum of the same terms in the same order), divided by
    the reference's coverage of the merged track."""
    import torch
    tr, cfg = ctx.traffic, ctx.config
    fps = cfg['audio']['sample_rate'] // cfg['audio']['hop_size']
    n_win = len(_starts(tr))
    hop = int(round(tr['step_seconds'] * fps))
    wins = windows.view(-1, n_win, *windows.shape[1:])
    t_win = wins.shape[2]
    total = t_win + (n_win - 1) * hop
    acc = wins.new_zeros((wins.shape[0], total, wins.shape[3]))
    for w in range(n_win):
        acc[:, w * hop:w * hop + t_win] += wins[:, w]
    coverage = torch.from_numpy(decode.coverage(
        total, tr['window_seconds'], hop)).to(acc)
    return acc / coverage[None, :, None]


def check(ctx, tensors: dict, requests: list, checked: dict) -> list:
    """``framewise_err``: the largest |program - plain reference (float32)|
    window output over the checked requests.  ``decode_errors``: the
    checked clips whose served events differ from the reference decoder's
    on the merge of the program's own window outputs (an exact
    comparison)."""
    cfg = ctx.config
    limits = ctx.cell.spec['limits']
    if not checked:
        return [('framewise_err', float('inf'), limits['framewise_err']),
                ('decode_errors', float('inf'), limits['decode_errors'])]
    ref = reference_windows(ctx, tensors, requests,
                            sorted({r for r, _, _ in checked.values()}))
    err, wrong = 0.0, 0
    for r, fw, events in checked.values():
        err = max(err, float((fw - ref[r]).abs().max()))
        probs = merged(fw, ctx).cpu().numpy()
        for j, evs in enumerate(events):
            wrong += sorted(decode.as_tuples(evs)) != sorted(
                decode.events(probs[j], cfg['classes']))
    return [('framewise_err', err, limits['framewise_err']),
            ('decode_errors', wrong, limits['decode_errors'])]


def reference_windows(ctx, tensors: dict, requests: list, which: list,
                      dtype=None) -> dict:
    """{request: (clips x windows, T, C) framewise outputs on the card} of
    the plain reference, window after window of each clip in order,
    ``batch_size`` windows a forward (``dtype``: its compute dtype)."""
    import torch
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    dtype = dtype or torch.float32
    sr = cfg['audio']['sample_rate']
    width = tr['window_seconds'] * sr
    offs = [int(s * sr) for s in _starts(tr)]
    params = {k: v.to(dtype) for k, v in tensors.items()}
    out = {}
    with torch.no_grad():
        for r in which:
            clips = torch.from_numpy(requests[r]).to(dev).float() \
                / tr['int16_scale']
            wins = torch.stack([clips[:, o:o + width] for o in offs],
                               dim=1).reshape(-1, width)
            out[r] = torch.cat([
                ctx.cell.reference.reference(
                    params, wins[i:i + tr['batch_size']], cfg,
                    dtype=dtype)[0]
                for i in range(0, len(wins), tr['batch_size'])])
    return out


def control(ctx) -> dict:
    """The readings that set the limit of ``framewise_err``, for one seed
    at the cell's own size: the program's (sound runs) over every request
    of the pool, served as the window serves them, and the control's (the
    plain reference in bfloat16 in the program's place)."""
    import torch
    dev = ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(ctx.config, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    engine = _engine(ctx, tensors)
    requests = _requests(ctx)
    every = list(range(len(requests)))
    capture = common.Capture(engine.model, every)
    served = {}
    for k in every:
        capture.now = k
        served[k] = _serve(engine, ctx, requests[k])
    capture.close()
    del engine
    common.free(dev)
    checks = dict((n, v) for n, v, _ in check(
        ctx, tensors, requests,
        {k: (k, capture.framewise(k), served[k]) for k in every}))
    ref = reference_windows(ctx, tensors, requests, every)
    low = reference_windows(ctx, tensors, requests, every, torch.bfloat16)
    events = sum(len(e) for evs in served.values() for e in evs)
    return {'program': checks['framewise_err'],
            'program.decode_errors': checks['decode_errors'],
            'control': max(float((low[r] - ref[r]).abs().max())
                           for r in every),
            'events_per_clip': events / sum(len(q) for q in requests)}
