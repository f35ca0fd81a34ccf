"""Device-side batch prefetch for the training loop (counterpart of
``sed_tpu/train/prefetch.py``).

A daemon thread assembles batch k+1 and copies it to the card while the
step runs batch k: from pinned host memory, ``non_blocking``, on a copy
stream of its own; the consumer's stream waits for that copy before it
reads the batch (the reference hides the same transfer with torch's
pinned-memory DataLoader, ``main_strong.py:254``).  The consumer's wait
for its next batch is the ``sed::train.batch_wait`` span; the producer
thread's work is not in a trace (a profiler records only the thread that
entered it).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from sed_tpu_torch.utils.profiling import span


def _to_tensor(x, device: torch.device, pin: bool):
    if isinstance(x, dict):
        return {k: _to_tensor(v, device, pin) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_tensor(v, device, pin) for v in x)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if not isinstance(x, torch.Tensor):
        return x
    if pin:
        x = x.pin_memory()
    return x.to(device, non_blocking=pin)


def _tensors(x):
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, torch.Tensor):
        yield x


class _Copied:
    """A batch copied on a side stream, with the event that ends it."""

    def __init__(self, item, event, device):
        self.item, self.event, self.device = item, event, device


def to_device(device='cuda') -> Callable:
    """The default ``put``: numpy arrays (in dicts, lists, tuples) ->
    tensors on ``device``; on a CUDA device through pinned memory on a
    copy stream."""
    device = torch.device(device)
    if device.type != 'cuda':
        return lambda item: _to_tensor(item, device, pin=False)
    stream = torch.cuda.Stream(device)

    def put(item):
        with torch.cuda.stream(stream):
            item = _to_tensor(item, device, pin=True)
            event = torch.cuda.Event()
            event.record(stream)
        return _Copied(item, event, device)

    return put


def device_prefetch(it: Iterator, size: int = 2,
                    put: Optional[Callable] = None,
                    device='cuda') -> Iterator:
    """Iterate ``it`` in a background thread, applying ``put`` (default
    ``to_device(device)``) to each item, so host -> device copies overlap
    the consumer's compute.  Items are yielded in order; exceptions from
    ``it`` or ``put`` re-raise at the consuming ``next()``.

    ``size`` bounds how many copied batches wait on the device.
    Abandoning the returned generator (the train loop reaches
    stop_iteration, or an exception unwinds it) stops the producer
    thread: it drops its queued batches and draws no more from ``it``.
    """
    if put is None:
        put = to_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        try:
            for item in it:
                if stop.is_set() or not _put(put(item)):
                    return
        except BaseException as e:      # re-raised by the consumer
            _put(_END)
            _put(e)
            return
        _put(_END)
        _put(None)

    threading.Thread(target=_produce, daemon=True).start()

    try:
        while True:
            with span('train.batch_wait'):
                item = q.get()
            if item is _END:
                err = q.get()
                if err is not None:
                    raise err
                return
            if isinstance(item, _Copied):
                current = torch.cuda.current_stream(item.device)
                current.wait_event(item.event)
                item = item.item
                for t in _tensors(item):
                    t.record_stream(current)
            yield item
    finally:
        stop.set()
