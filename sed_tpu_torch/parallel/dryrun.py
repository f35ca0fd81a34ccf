"""Four-stage multi-device dry run on the CPU (counterpart of
``__graft_entry__.dryrun_multichip``)::

    python -m sed_tpu_torch.parallel.dryrun 4

Cnn_9layers_Gru_FrameAtt at full width, 16 kHz, 1 s clips, fresh init:

1. one data-parallel joint step (mixup, timeshift and SpecAugment on) in
   ``n`` gloo processes, two clips a rank: a finite loss, step 1;
2. ``predict_clips`` of the trained model on ``n`` CPU replicas
   (``SedInferenceEngine(devices=['cpu'] * n)``);
3. the q6 wire on the replicas: events and XML identical to the
   single-device engine (``sed_tpu``'s third stage serves the resident
   path, which the port does not have);
4. with ``n >= 4`` and even: data x FSDP on a (2, n / 2) mesh, the larger
   parameters sharded over ``model`` (``conv_block4.conv2.weight``
   among them), one step with a finite loss.
"""

from __future__ import annotations

import os
import sys

import numpy as np

MODEL = 'Cnn_9layers_Gru_FrameAtt'


def batches(n: int, sr: int, seed: int = 0) -> tuple:
    """Global weak and strong batches of ``2 n`` clips of 1 s with mixup
    lambdas, as ``sed_tpu``'s dry run makes them."""
    from sed_tpu_torch.config import CLASSES_NUM
    rng = np.random.RandomState(seed)
    weak = {'waveform': rng.uniform(-0.1, 0.1, (2 * n, sr)).astype(np.float32),
            'target': (rng.rand(2 * n, CLASSES_NUM) > 0.8).astype(np.float32),
            'mixup_lambda': np.repeat(rng.rand(n), 2).astype(np.float32)}
    strong = {'waveform': rng.uniform(-0.1, 0.1, (2 * n, sr))
              .astype(np.float32),
              'strong_target': (rng.rand(2 * n, 100, CLASSES_NUM) > 0.9)
              .astype(np.float32),
              'mixup_lambda': np.repeat(rng.rand(n), 2).astype(np.float32)}
    return weak, strong


def _train_state(cfg):
    import torch
    from sed_tpu_torch.models.registry import get_model
    from sed_tpu_torch.train.state import create_train_state
    return create_train_state(get_model(MODEL, cfg), 1e-3,
                              torch.Generator().manual_seed(0))


def _step(state, group, mesh, n, cfg, seed: int) -> float:
    import torch
    from sed_tpu_torch import losses
    from sed_tpu_torch.parallel.mesh import shard_batch
    from sed_tpu_torch.train.step import make_train_step
    step = make_train_step(state.model, state.optimizer, losses.clip_bce,
                           losses.frame_bce, mixup=True, timeshift=True,
                           spec_augment=True, group=group)
    weak, strong = batches(n, cfg.sample_rate)
    metrics = step(shard_batch(weak, mesh), [shard_batch(strong, mesh)],
                   torch.Generator().manual_seed(seed))
    return metrics['loss'].item()


def _rank(rank: int, n: int, store: str) -> dict:
    """Stages 1 and 4 on one gloo rank."""
    import torch
    import torch.distributed as dist
    from sed_tpu_torch.config import AUDIO_16K
    from sed_tpu_torch.parallel.mesh import fsdp_shard, make_mesh
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=n)
    try:
        out = {}
        state = _train_state(AUDIO_16K)
        out['dp_loss'] = _step(state, dist.group.WORLD, None, n, AUDIO_16K,
                               seed=1)
        out['dp_step'] = state.step
        if rank == 0:
            out['state'] = {k: v.detach().clone()
                            for k, v in state.model.state_dict().items()}
        if n >= 4 and n % 2 == 0:
            mesh = make_mesh(n, ('data', 'model'), (2, n // 2))
            state = _train_state(AUDIO_16K)
            out['wrapped'] = fsdp_shard(state.model, mesh, min_size=4096)
            w = state.model.conv_block4.conv2.weight
            out['conv_block4'] = (tuple(w.shape),
                                  tuple(w.to_local().shape)
                                  if hasattr(w, 'to_local') else None)
            out['fsdp_loss'] = _step(state, mesh.get_group('data'), mesh, n,
                                     AUDIO_16K, seed=2)
        return out
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 900.0) -> dict:
    """The four stages; each prints one line and raises on a failure.
    Returns the ranks' results and the serving events."""
    from sed_tpu_torch.config import AUDIO_16K, PREDICT_SED_PARAMS
    from sed_tpu_torch.data import audio_io
    from sed_tpu_torch.models.registry import get_model
    from sed_tpu_torch.parallel.distributed import spawn_ranks
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    n, cfg = n_devices, AUDIO_16K
    ranks = spawn_ranks(_rank, n, timeout=timeout)
    loss = ranks[0]['dp_loss']
    assert np.isfinite(loss), f'non-finite loss {loss}'
    assert all(r['dp_loss'] == loss for r in ranks), \
        [r['dp_loss'] for r in ranks]
    assert all(r['dp_step'] == 1 for r in ranks)
    print(f'dryrun_multichip({n}) dp ok: loss={loss:.4f}, step=1 on each of '
          f'{n} gloo ranks')

    model = get_model(MODEL, cfg)
    model.load_state_dict(ranks[0]['state'])
    kw = dict(sample_duration=5, overlap=True, sed_params=PREDICT_SED_PARAMS,
              batch_size=2 * n)
    eng = SedInferenceEngine(model, cfg, devices=['cpu'] * n, **kw)
    clips = np.random.RandomState(0).uniform(
        -0.3, 0.3, (2 * n, cfg.sample_rate * 5)).astype(np.float32)
    events, xmls = eng.predict_clips(clips)
    assert len(events) == 2 * n and len(xmls) == 2 * n
    assert all(x.startswith('<AudioDoc') for x in xmls)
    print(f'dryrun_multichip({n}) serving ok: '
          f'{sum(len(e) for e in events)} events decoded on {n} replicas')

    one = SedInferenceEngine(model, cfg, 'cpu', **kw)
    q6 = audio_io.qn_encode(clips, 6)
    got, want = eng.predict_clips(q6), one.predict_clips(q6)
    assert got == want, 'q6 events on the replicas differ from one device'
    print(f'dryrun_multichip({n}) q6 serving ok: '
          f'{sum(len(e) for e in got[0])} events, replicas == single-device')

    if n >= 4 and n % 2 == 0:
        full, shard = ranks[0]['conv_block4']
        loss2 = ranks[0]['fsdp_loss']
        assert shard is not None and shard[0] < full[0], (full, shard)
        assert np.isfinite(loss2), f'non-finite fsdp loss {loss2}'
        print(f'dryrun_multichip({n}) dp x fsdp ok: loss={loss2:.4f} on a '
              f'(2, {n // 2}) mesh, {len(ranks[0]["wrapped"])} modules '
              f'sharded, conv_block4.conv2.weight {full} held as {shard}')
    return {'ranks': ranks, 'events': events}


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(
        description='data-parallel and dp x fsdp dry run in gloo CPU '
                    'processes')
    parser.add_argument('n_devices', type=int, nargs='?', default=4,
                        help='processes (ranks) and serving replicas')
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices)


if __name__ == '__main__':
    main(sys.argv[1:])
