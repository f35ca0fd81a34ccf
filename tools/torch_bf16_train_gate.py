#!/usr/bin/env python3
"""Loss trajectory of sed_tpu_torch's bf16 conv stack against float32 on
the CPU, the measurement behind ``chip_smoke.py:BF16_LOSS_RTOL``.

    python tools/torch_bf16_train_gate.py narrow   # channels 16-128, 2 s
    python tools/torch_bf16_train_gate.py full     # full width, 1 s

Cnn_9layers_Gru_FrameAtt from one fresh init (``init_weights``, seed 0),
25 joint steps on weak 12 + strong 4 bench-corpus int16 clips a step
(mixup, SpecAugment and timeshift on, one generator seeded 1234), in
float32 and with ``compute_dtype=torch.bfloat16`` under the dynamic loss
scale; prints both loss trajectories and each step's |bf16 - float32| /
float32.
"""

import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO]

from sed_tpu_torch import losses  # noqa: E402
from sed_tpu_torch.augment.functional import MixupGenerator  # noqa: E402
from sed_tpu_torch.bench_corpus import make_clips  # noqa: E402
from sed_tpu_torch.config import AUDIO_16K  # noqa: E402
from sed_tpu_torch.models.registry import get_model  # noqa: E402
from sed_tpu_torch.train.state import create_train_state  # noqa: E402
from sed_tpu_torch.train.step import (init_loss_scale,  # noqa: E402
                                      make_train_step)

WEAK, STRONG, STEPS = 12, 4, 25
SIZES = {'narrow': (dict(conv_channels=(16, 32, 64, 128), gru_hidden=64), 2),
         'full': ({}, 1)}


def batches(seconds: int) -> list:
    """``STEPS`` (weak, strong) batches of int16 clips drawn from two
    pools in a seeded order, with the reference's mixup lambda stream."""
    cfg, rng, mix = AUDIO_16K, np.random.RandomState(0), MixupGenerator(1.0)
    pcm = {n: (make_clips(n, cfg.sample_rate, seconds=seconds, seed=seed)
               * 32767).astype(np.int16)
           for n, seed in ((WEAK, 1), (STRONG, 2))}
    weak_t = (rng.rand(WEAK, 25) > 0.8).astype(np.float32)
    strong_t = (rng.rand(STRONG, seconds * 100, 25) > 0.9).astype(np.float32)
    out = []
    for _ in range(STEPS):
        wi, si = rng.permutation(WEAK), rng.permutation(STRONG)
        out.append((
            {'waveform': torch.from_numpy(pcm[WEAK][wi]),
             'target': torch.from_numpy(weak_t[wi]),
             'mixup_lambda': torch.from_numpy(
                 mix.get_lambda(WEAK).astype(np.float32))},
            {'waveform': torch.from_numpy(pcm[STRONG][si]),
             'strong_target': torch.from_numpy(strong_t[si]),
             'mixup_lambda': torch.from_numpy(
                 mix.get_lambda(STRONG).astype(np.float32))}))
    return out


def trajectory(size: str, compute_dtype, data: list) -> list:
    kwargs, _ = SIZES[size]
    model = get_model('Cnn_9layers_Gru_FrameAtt', AUDIO_16K,
                      compute_dtype=compute_dtype, **kwargs)
    state = create_train_state(model, 1e-3, torch.Generator().manual_seed(0))
    scaled = compute_dtype is not None
    step = make_train_step(model, state.optimizer, losses.clip_bce,
                           losses.frame_bce, mixup=True, timeshift=True,
                           spec_augment=True,
                           loss_scale='dynamic' if scaled else None)
    generator, scale, out = torch.Generator().manual_seed(1234), \
        init_loss_scale(), []
    for weak, strong in data:
        if scaled:
            metrics, scale = step(weak, [strong], generator, scale)
            assert metrics['grads_finite']
        else:
            metrics = step(weak, [strong], generator)
        out.append(metrics['loss'].item())
    return out


def main(argv) -> None:
    size = argv[0] if argv else 'narrow'
    data = batches(SIZES[size][1])
    got = {}
    for tag, dtype in (('float32', None), ('bf16', torch.bfloat16)):
        t0 = time.perf_counter()
        got[tag] = np.array(trajectory(size, dtype, data))
        print(f'{tag}: {time.perf_counter() - t0:.1f} s, losses '
              f'{got[tag].tolist()}')
    rel = np.abs(got['bf16'] - got['float32']) / got['float32']
    print(f'{size}: |bf16 - float32| / float32 per step {rel.tolist()}')
    print(f'{size}: max {rel.max()!r} (step {int(rel.argmax()) + 1}), first '
          f'step {rel[0]!r}')


if __name__ == '__main__':
    main(sys.argv[1:])
