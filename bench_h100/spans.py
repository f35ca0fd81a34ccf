"""The program's own spans in a traced segment.

The port marks the boundaries of its host stages with ``sed::<name>``
spans (``sed_tpu_torch/utils/profiling.span``): host operator events,
recorded only while a profiler runs, on the thread that made them.  The
readers here take those on the measuring thread of a ``trace.Trace``
(the thread that ran the benchmark's marker span) and return None where
the segment holds none, as a program without the spans gives.  Times in
microseconds.
"""

from __future__ import annotations

from typing import Optional

from bench_h100.trace import _union


def _events(trace, names) -> list:
    want = {f'sed::{n}' for n in names}
    return [e for e in trace.host
            if e.name in want and e.thread == trace.thread]


def count(trace, *names) -> int:
    """How many spans of any of ``names`` the segment holds."""
    return len(_events(trace, names))


def intervals(trace, *names) -> list:
    """The union of the spans of ``names``: sorted, disjoint [start, end]."""
    return _union([e.time_range.start, e.time_range.end]
                  for e in _events(trace, names))


def host_us(trace, *names) -> Optional[float]:
    """Host time inside the spans of ``names`` (their union)."""
    spans = intervals(trace, *names)
    return sum(e - s for s, e in spans) if spans else None


def overlap_us(a: list, b: list) -> float:
    """Total overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_us(trace, *names) -> Optional[float]:
    """Device-idle time under the spans of ``names``: each idle gap of
    the segment counted for exactly the part of it that the spans cover."""
    spans = intervals(trace, *names)
    if not spans:
        return None
    return overlap_us(trace.idle_gaps(), spans)
