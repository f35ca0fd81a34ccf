"""Profiling / tracing hooks (counterpart of ``sed_tpu/utils/profiling.py``).

The reference has no tracing at all — only wall-clock prints
(``main_strong.py:767,838-841``; SURVEY §5).  This provides:

* ``trace(logdir)``: a context manager around ``torch.profiler`` so any
  block (a train step, the serving loop) writes a Chrome trace of its
  host and, where there is a card, its device activity into ``logdir``
  (loadable in Perfetto or ``chrome://tracing``);
* ``StepTimer``: a lightweight rolling step timer for train loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (CPU activity, and CUDA activity when
    CUDA is available) and write ``logdir/trace_<pid>_<ns>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


class StepTimer:
    """Rolling steps/sec and examples/sec."""

    def __init__(self, window: int = 50):
        self._times: deque = deque(maxlen=window)
        self._counts: deque = deque(maxlen=window)
        self._last: Optional[float] = None

    def step(self, examples: int = 1) -> None:
        now = time.time()
        if self._last is not None:
            self._times.append(now - self._last)
            self._counts.append(examples)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        total = sum(self._times)
        return len(self._times) / total if total else 0.0

    @property
    def examples_per_sec(self) -> float:
        total = sum(self._times)
        return sum(self._counts) / total if total else 0.0
