"""Rank functions of ``tests/test_torch_parallel.py``, run by
``sed_tpu_torch.parallel.distributed.spawn_ranks`` in fresh processes.

Kept apart from the test module so that a rank imports torch and the
port only (no JAX).  Each joins a gloo group through the ``FileStore``
path it is given and destroys the group in a ``finally``.
"""

import numpy as np
import torch
import torch.distributed as dist

from sed_tpu_torch import losses
from sed_tpu_torch.config import AUDIO_16K
from sed_tpu_torch.models.zoo import CnnSed
from sed_tpu_torch.parallel.mesh import fsdp_shard, make_mesh, shard_batch
from sed_tpu_torch.train.state import create_train_state
from sed_tpu_torch.train.step import (LossScaleState, make_train_step)

CFG = AUDIO_16K
LR = 1e-3


def narrow_model(temporal: str, state_dict=None) -> CnnSed:
    """The narrow CnnSed of the training tests (conv channels 8/16/16/32,
    GRU 16 or a MultiHead over 32), with ``state_dict`` loaded."""
    model = CnnSed(CFG, temporal=temporal, conv_channels=(8, 16, 16, 32),
                   head='att', gru_hidden=16, pad_to_roundup=True)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def step_for(model, group=None, loss_scale=None, augment=True):
    state = create_train_state(model, LR, fresh=False)
    step = make_train_step(model, state.optimizer, losses.clip_bce,
                           losses.frame_bce, mixup=True, timeshift=augment,
                           spec_augment=augment, loss_scale=loss_scale,
                           group=group)
    return state, step


def _join(rank, n, store):
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{store}',
                            rank=rank, world_size=n)


def _full(t):
    """A tensor, or a DTensor gathered whole (a collective)."""
    return t.full_tensor() if hasattr(t, 'full_tensor') else t


def _result(state, metrics):
    model = state.model
    return {'grads': {k: _full(p.grad).detach().clone()
                      for k, p in model.named_parameters()},
            'state': {k: _full(v).detach().clone()
                      for k, v in model.state_dict().items()},
            'metrics': {k: (v.item() if torch.is_tensor(v) else v)
                        for k, v in metrics.items()},
            'step': state.step}


def dp_steps(rank, n, store, runs, skip):
    """In one group: for each ``(temporal, state_dict, weak, strong,
    seed)`` of ``runs`` one data-parallel step of a fresh model on this
    rank's share of the global batch; then ``skip_step(*skip)``."""
    _join(rank, n, store)
    try:
        out = []
        for temporal, state_dict, weak, strong, seed in runs:
            model = narrow_model(temporal, state_dict)
            state, step = step_for(model, dist.group.WORLD)
            metrics = step(shard_batch(weak), [shard_batch(strong)],
                           torch.Generator().manual_seed(seed))
            out.append(_result(state, metrics))
        return out, skip_step(*skip)
    finally:
        dist.destroy_process_group()


def dp_fsdp_step(rank, n, store, temporal, state_dict, weak, strong, seed):
    """One step on a (2, n / 2) ('data', 'model') mesh with the
    parameters of at least 512 elements sharded over 'model'."""
    _join(rank, n, store)
    try:
        mesh = make_mesh(n, ('data', 'model'), (2, n // 2))
        model = narrow_model(temporal, state_dict)
        wrapped = fsdp_shard(model, mesh, min_size=512)
        w = model.conv_block4.conv2.weight
        shard = tuple(w.to_local().shape) if hasattr(w, 'to_local') else None
        state, step = step_for(model, mesh.get_group('data'))
        metrics = step(shard_batch(weak, mesh), [shard_batch(strong, mesh)],
                       torch.Generator().manual_seed(seed))
        out = _result(state, metrics)
        out.update(wrapped=wrapped, shard=shard)
        return out
    finally:
        dist.destroy_process_group()


def skip_step(state_dict, weak, strong, bad_row):
    """On a joined group: a clean loss-scaled step, then one whose global
    row ``bad_row`` holds an ``inf``: whether the bad step was finite,
    whether it left every tensor as it was, the scales, the step count
    and the state."""
    model = narrow_model('gru', state_dict)
    state, step = step_for(model, dist.group.WORLD, 'dynamic',
                           augment=False)
    gen = torch.Generator().manual_seed(0)
    m, ss = step(shard_batch(weak), [shard_batch(strong)], gen,
                 LossScaleState(4096.0, 0))
    assert m['grads_finite']
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = [{k: v.clone() for k, v in state.optimizer.state[p]
                   .items() if torch.is_tensor(v)}
                  for p in model.parameters()]
    bad = dict(weak, waveform=weak['waveform'].copy())
    bad['waveform'][bad_row, 0] = np.inf
    m, ss2 = step(shard_batch(bad), [shard_batch(strong)], gen, ss)
    same = all(torch.equal(v, before[k])
               for k, v in model.state_dict().items()) and all(
        torch.equal(v, o[k]) for p, o in zip(model.parameters(),
                                             opt_before)
        for k, v in state.optimizer.state[p].items()
        if torch.is_tensor(v))
    return {'finite': m['grads_finite'], 'unchanged': same,
            'scale': (ss.scale, ss2.scale), 'step': state.step,
            'state': {k: v.clone() for k, v in
                      model.state_dict().items()}}


def cli_train(rank, n, store, argv):
    """``main_strong.main(argv)`` on a rank of an initialised group (the
    CLI finds the group and trains data-parallel)."""
    from sed_tpu_torch.cli import main_strong
    _join(rank, n, store)
    try:
        state = main_strong.main(argv)
        return {'step': state.step,
                'state': {k: v.detach().clone()
                          for k, v in state.model.state_dict().items()}}
    finally:
        dist.destroy_process_group()
