"""Profiling / tracing hooks (counterpart of ``sed_tpu/utils/profiling.py``).

The reference has no tracing at all — only wall-clock prints
(``main_strong.py:767,838-841``; SURVEY §5).  This provides:

* ``trace(logdir)``: a context manager around ``torch.profiler`` so any
  block (a train step, the serving loop) writes a Chrome trace of its
  host and, where there is a card, its device activity into ``logdir``
  (loadable in Perfetto or ``chrome://tracing``);
* ``span(name, into, key)``: a ``sed::<name>`` span around one host stage
  of the program, recorded while a profiler runs, so that each idle gap
  of the device trace can be put down to the stage the host was in.

A span is a host operator event (a ``cpu_op``, as an ``aten::`` operator
is), never a user annotation: the profiler mirrors a user annotation on
the device from its first kernel to its last, which would fill the
device's idle gaps.  Spans are recorded while a profiler runs (under
``trace``, or any ``torch.profiler.profile``; it records only the thread
that entered it) and cost one probe of the profiler's state otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_profiler_on = torch._C._autograd._profiler_enabled
_HostOp = torch._C._profiler._RecordFunctionFast


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (CPU activity, and CUDA activity when
    CUDA is available) and write ``logdir/trace_<pid>_<ns>.json``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


class span:
    """``with span('serve.decode'):`` records a host operator event
    ``sed::serve.decode`` around the block while a profiler runs.  When
    ``into`` is a dict, the block's host-clock seconds are also added to
    ``into[key]`` (started at 0), profiler or not."""

    __slots__ = ('_name', '_into', '_key', '_op', '_t0')

    def __init__(self, name: str, into: Optional[dict] = None,
                 key: Optional[str] = None):
        self._name, self._into, self._key = name, into, key

    def __enter__(self) -> 'span':
        self._op = _HostOp('sed::' + self._name) if _profiler_on() else None
        if self._op is not None:
            self._op.__enter__()
        if self._into is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._into is not None:
            self._into[self._key] = (self._into.get(self._key, 0.0)
                                     + time.perf_counter() - self._t0)
        if self._op is not None:
            self._op.__exit__(*exc)
        return False
