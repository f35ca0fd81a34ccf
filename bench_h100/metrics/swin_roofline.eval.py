"""``swin_roofline.eval``: HTS-AT's Swin encoder (``models/htsat.
SwinEncoder``: the four stages and the final LayerNorm) against its
roofline, in %: the least time an H100 could take for the traced
segment's encoder forwards over their device time, launched under the
program's ``sed::htsat.encoder`` spans.  The least time is the larger of
the encoder's counted operations (its configuration's ``encoder_flop`` a
window: the linears, PatchMerging and the attention's two products) at
the fp32 peak, since the drivers run float32 without TF32, and its bytes
(``encoder_bytes``: the weights once a forward, each window's stage-1
tokens in and stage-4 tokens out once) at the HBM rate
(``yardstick.py``).  None where the segment holds no such span, as
another model or a program without the span gives."""

from bench_h100 import spans, yardstick


def read(run):
    if run.trace is None or run.info.get('kind') != 'eval':
        return None
    forwards = spans.count(run.trace, 'htsat.encoder')
    us = run.trace.span_us('sed::htsat.encoder') if forwards else 0.0
    if not us:
        return None
    info = run.info
    config, model = info['config'], info['model']
    windows = info['traced_clips'] * info['windows'] / info['clips']
    least_s = max(windows * model.encoder_flop(config)
                  / yardstick.PEAK_FP32_FLOPS,
                  forwards * model.encoder_bytes(config, windows / forwards)
                  / yardstick.PEAK_HBM_BYTES)
    return 100.0 * least_s / (us / 1e6)
