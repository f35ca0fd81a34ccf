"""The yardstick: the H100's peaks, and the operations and bytes of the
work, counted from shapes and never from what the program ran.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense.
``mfu.*`` divide by the bf16 tensor-core peak, the card's highest dense
rate: cuDNN's FFT and Winograd convolutions already do the counted work
of the float32 convolutions faster than the 67 TFLOP/s float32 peak, so
a share of that peak could pass 100%.

Counting:
- log-mel, as an FFT does it (a copy of ``chip_smoke.needed_gflop``): the
  window product, a real FFT of n points (2.5 n log2 n), the power
  spectrum (3 a bin), a multiply-add for each nonzero tap of the mel
  filters and the dB scaling (4 a mel bin), per frame;
- each 3x3 convolution as a direct one: 2 Cin Cout 9 H W;
- the temporal block between the conv stack and the head, as its
  configuration's ``temporal_flop`` counts it (``configs/<config>.py``);
- the head: two 2 d C products a frame;
- training: the backward as twice the forward of everything after the
  frontend (the log-mel has no parameter and needs no backward).
"""

from __future__ import annotations

import math

import numpy as np

PEAK_BF16_FLOPS = 989e12       # dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12        # fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


def frames(config: dict, samples: int) -> int:
    """STFT frames of a clip with center padding."""
    return samples // config['audio']['hop_size'] + 1


def logmel_flop(config: dict, rows: int) -> float:
    """Operations log-mel needs for ``rows`` frames."""
    from bench_h100.reference.plain import mel_filterbank
    a = config['audio']
    n, bins = a['window_size'], a['window_size'] // 2 + 1
    taps = np.count_nonzero(mel_filterbank(a['sample_rate'], n, a['mel_bins'],
                                           a['fmin'], a['fmax']))
    return rows * (n + 2.5 * n * math.log2(n) + 3 * bins + 2 * taps
                   + 4 * a['mel_bins'])


def logmel_bound_s(config: dict, batch: int, samples: int) -> tuple:
    """The least time an H100 SXM could take for log-mel of a (batch,
    samples) float32 input (a copy of ``chip_smoke.bound_ms``): the
    larger of its operations at the fp32 peak and its bytes (waveform,
    window and mel matrix read once, log-mel written once) over the HBM
    rate; and which of the two bounds it."""
    a = config['audio']
    t = frames(config, samples)
    bins = a['window_size'] // 2 + 1
    nbytes = 4 * (batch * samples + a['window_size'] + bins * a['mel_bins']
                  + batch * t * a['mel_bins'])
    ops_s = logmel_flop(config, batch * t) / PEAK_FP32_FLOPS
    bytes_s = nbytes / PEAK_HBM_BYTES
    return max(ops_s, bytes_s), ('operations' if ops_s >= bytes_s
                                 else 'bytes')


def body_flop(config: dict, samples: int, temporal_flop) -> float:
    """Operations of one clip's forward after the log-mel frontend;
    ``temporal_flop(config, frames, width)``: the temporal block's
    operations and output width."""
    t, f = frames(config, samples), config['audio']['mel_bins']
    total, cin = 0.0, 1
    chans = config['conv_channels']
    for i, cout in enumerate(chans):
        total += 2 * cin * cout * 9 * t * f + 2 * cout * cout * 9 * t * f
        cin = cout
        if i < len(chans) - 1:
            t, f = t // 2, f // 2
    flop, d = temporal_flop(config, t, cin)
    return total + flop + 2 * 2 * t * d * len(config['classes'])


def forward_flop(config: dict, samples: int, temporal_flop) -> float:
    """Operations of one clip's forward, frontend included."""
    return logmel_flop(config, frames(config, samples)) \
        + body_flop(config, samples, temporal_flop)


def train_step_flop(config: dict, samples: int, clips: int,
                    mixed_rows: int, temporal_flop) -> float:
    """Operations of one joint train step: log-mel of every clip, then
    forward and backward (3x the forward) of the rows mixup leaves."""
    return clips * logmel_flop(config, frames(config, samples)) \
        + 3 * mixed_rows * body_flop(config, samples, temporal_flop)
