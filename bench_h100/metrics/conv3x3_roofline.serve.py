"""``conv3x3_roofline.serve``: the conv stack's eval-mode 3x3
convolutions (``csrc/conv3x3.cu``) against their roofline, in %: the
least time an H100 could take for the traced segment's convolutions over
their device time, launched under the program's ``sed::conv.3x3`` spans.

The least time is the larger of two bounds:

- operations: each convolution counted as a direct one, 2 Cin Cout 9 H W
  a clip (``yardstick.body_flop``'s loop), over ``PEAK_3XTF32_FLOPS``;
- bytes: each convolution's input, weights and output once, over the HBM
  rate (``yardstick.PEAK_HBM_BYTES``).

The peak is 165 TFLOP/s and not the 67 TFLOP/s of fp32 outside the
tensor cores (``yardstick.PEAK_FP32_FLOPS``): the kernel runs float32
products on the TF32 tensor cores as three passes (operands split into
hi and lo, hi hi + hi lo + lo hi), which keeps fp32 accuracy, so its
ceiling is the 495 TFLOP/s dense TF32 rate over three.  A kernel that
read above 100% of it would have dropped a pass, and with it the fp32
accuracy.  None where the segment holds no such span."""

from bench_h100 import spans, yardstick

PEAK_3XTF32_FLOPS = 495e12 / 3


def read(run):
    if run.trace is None or run.info.get('kind') != 'serve':
        return None
    launches = spans.count(run.trace, 'conv.3x3')
    us = run.trace.span_us('sed::conv.3x3') if launches else 0.0
    if not us:
        return None
    config = run.info['config']
    clips = run.info['traced_clips']
    t = yardstick.frames(config, run.info['clip_samples'])
    f = config['audio']['mel_bins']
    chans = config['conv_channels']
    flop = act_bytes = weight_bytes = 0.0
    cin = 1
    for i, cout in enumerate(chans):
        for a, b in ((cin, cout), (cout, cout)):
            flop += 2 * a * b * 9 * t * f
            act_bytes += 4 * (a + b) * t * f
            weight_bytes += 4 * 9 * a * b
        cin = cout
        if i < len(chans) - 1:
            t, f = t // 2, f // 2
    forwards = launches / (2 * len(chans))
    least_s = max(clips * flop / PEAK_3XTF32_FLOPS,
                  (clips * act_bytes + forwards * weight_bytes)
                  / yardstick.PEAK_HBM_BYTES)
    return 100.0 * least_s / (us / 1e6)
