"""Process-group wiring (counterpart of ``sed_tpu/parallel/distributed.py``).

``sed_tpu`` joins one JAX runtime per host; the port runs one process per
card, as ``torchrun`` starts them::

    torchrun --nproc_per_node N -m sed_tpu_torch.cli.main_strong train ...

Every process draws the SAME seeded global batch stream and loads only
its share (``HostShardedSampler``); the train step averages gradients
over the group (``train/step.py``).  The group uses NCCL on CUDA and gloo
on the CPU.  ``sed_tpu``'s ``SED_TPU_MULTIHOST`` (Cloud TPU pod
auto-detection) has no counterpart: torchrun sets the variables below.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Iterator, List, Optional

TORCHRUN_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT')


def maybe_initialize(device='cpu') -> bool:
    """Join the process group that torchrun's environment describes.

    Returns True when ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` are all set (or the group already
    exists): the group is then initialised, with NCCL when ``device`` is
    a CUDA device and gloo otherwise.  None set: a single-process run,
    False.  Some set: a partially wired launch, which must not run every
    process as an independent copy of the job, raises naming the
    variables that are set and those that are missing.
    """
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return True
    have = {k: os.environ.get(k) for k in TORCHRUN_ENV}
    missing = [k for k, v in have.items() if not v]
    if len(missing) == len(have):
        return False
    if missing:
        raise RuntimeError(
            'multi-process launch is partially configured: '
            f'{[k for k in have if k not in missing]} set but {missing} '
            'missing; start the processes with torchrun, or set all of '
            f'{list(TORCHRUN_ENV)}')
    backend = 'nccl' if torch.device(device).type == 'cuda' else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(int(have['LOCAL_RANK']))
    dist.init_process_group(backend, init_method='env://')
    logging.info('torch.distributed initialised: rank %d of %d (%s, %s:%s)',
                 dist.get_rank(), dist.get_world_size(), backend,
                 have['MASTER_ADDR'], have['MASTER_PORT'])
    return True


def rank() -> int:
    """This process's rank in the default group, 0 without one."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def world_size() -> int:
    """The default group's size, 1 without one."""
    import torch.distributed as dist
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def local_device(device) -> 'torch.device':
    """``device`` for this process: ``cuda`` becomes ``cuda:LOCAL_RANK``
    under torchrun; any other device is returned as it is."""
    import torch
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None \
            and os.environ.get('LOCAL_RANK'):
        return torch.device('cuda', int(os.environ['LOCAL_RANK']))
    return device


class HostShardedSampler:
    """Wrap a batch-meta sampler so each process fetches only its share.

    All processes construct identically-seeded samplers (so the global
    stream is the same everywhere) and slice ``[k*share:(k+1)*share]`` —
    per-process HDF5 IO drops by ``1/process_count`` instead of loading
    the global batch and discarding most of it.
    """

    def __init__(self, sampler, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 even_shares: bool = False):
        if process_index is None:
            process_index = rank()
        if process_count is None:
            process_count = world_size()
        self.sampler = sampler
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        # pair-based augmentation (mixup) consumes consecutive sample
        # PAIRS with globally drawn (lam, 1-lam) lambdas: an odd
        # per-process share would split a pair across processes and
        # misalign every following lambda slice
        self.even_shares = even_shares

    def __iter__(self) -> Iterator[List[dict]]:
        k, n = self.process_index, self.process_count
        for batch_meta in self.sampler:
            if n == 1:
                yield batch_meta
                continue
            share = len(batch_meta) // n
            assert share * n == len(batch_meta), (
                f'global batch {len(batch_meta)} must divide over '
                f'{n} processes')
            assert not (self.even_shares and share % 2), (
                f'per-process share {share} must be even to keep mixup '
                f'pairs process-local (global batch {len(batch_meta)}, '
                f'{n} processes)')
            yield batch_meta[k * share:(k + 1) * share]


def spawn_ranks(fn, n: int, args: tuple = (), timeout: float = 600.0,
                store_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, n, store_path, *args)`` in ``n`` fresh processes
    (``spawn``) and return their results in rank order.

    The processes meet through a ``FileStore`` file under ``store_dir``
    (a temporary directory by default), never a fixed port, so that
    concurrent runs cannot collide; ``fn`` joins the group with
    ``init_process_group(backend, init_method='file://' + store_path,
    rank=rank, world_size=n)`` and destroys it in a ``finally``.  A rank
    that raises, exits without a result or outlives ``timeout`` seconds
    makes this raise; every process is ended before it returns.  ``fn``
    and ``args`` must pickle (a module-level function).
    """
    import multiprocessing
    import queue as queue_lib
    import tempfile
    import time
    ctx = multiprocessing.get_context('spawn')
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, 'store')
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, k, n, store, args, results),
                             daemon=True)
                 for k in range(n)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout
        try:
            # drain the queue before joining: a child blocks until its
            # result is read
            while len(got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f'{n - len(got)} of {n} ranks did not '
                                       f'finish in {timeout} s')
                try:
                    k, ok, value = results.get(timeout=min(left, 1.0))
                except queue_lib.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and i not in got]
                    if dead:
                        raise RuntimeError(f'ranks {dead} exited with '
                                           f'{[procs[i].exitcode for i in dead]}')
                    continue
                if not ok:
                    raise RuntimeError(f'rank {k} failed:\n{value}')
                got[k] = pickle.loads(value)
        finally:
            for p in procs:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    return [got[r] for r in range(n)]


def _rank_main(fn, k, n, store, args, results) -> None:
    import traceback
    try:
        # pickled by value here: a tensor put on the queue as it is would
        # be shared through a file descriptor of a process about to exit
        results.put((k, True, pickle.dumps(fn(k, n, store, *args))))
    except BaseException:                    # reported to the parent
        results.put((k, False, traceback.format_exc()))
        raise
