"""``encoder_roofline.serve``: the Conformer encoder
(``models/encoders.ConformerEncoder``) against its roofline, in %: the
least time an H100 could take for the traced segment's encoder forwards
over their device time, launched under the program's
``sed::conformer.encoder`` spans.  The least time is the larger of the
encoder's counted operations (its configuration's ``temporal_flop`` a
clip) at the fp32 peak, since the drivers run float32 without TF32, and
its bytes (``temporal_bytes``: the weights once a forward, each clip's
input and output once) at the HBM rate (``yardstick.py``)."""

from bench_h100 import spans, yardstick


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve':
        return None
    forwards = spans.count(run.trace, 'conformer.encoder')
    us = run.trace.span_us('sed::conformer.encoder') if forwards else 0.0
    if not us:
        return None
    config, model = run.info['config'], run.info['model']
    clips = run.info['traced_clips']
    t = yardstick.frames(config, run.info['clip_samples'])
    for _ in config['conv_channels'][:-1]:
        t //= 2
    d = config['conv_channels'][-1]
    flop = clips * model.temporal_flop(config, t, d)[0]
    nbytes = forwards * model.temporal_bytes(config, t, d, clips / forwards)
    least_s = max(flop / yardstick.PEAK_FP32_FLOPS,
                  nbytes / yardstick.PEAK_HBM_BYTES)
    return 100.0 * least_s / (us / 1e6)
