"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy time as the union of its busy intervals on every
stream (never a sum of self times, so shares stay in [0, 1]), device
time by operator group and by the benchmark's own spans, kernel time by
name, and the idle gaps labelled by what the host was doing.

Only events inside the benchmark's marker span count: the traced
segment starts with an unmarked warm call, since a profile can lose the
first kernels of its trace.
"""

from __future__ import annotations

import collections
import heapq

MARKER = 'bench::measured'


def _device_us(e) -> float:
    """Device time of a host event and its children (kernels included)."""
    for attr in ('device_time_total', 'cuda_time_total'):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The marked window of one profile.  Times in microseconds."""

    def __init__(self, prof):
        from torch.autograd import DeviceType
        events = list(prof.events())
        host = [e for e in events if e.device_type == DeviceType.CPU]
        marks = [e for e in host if e.name == MARKER]
        if len(marks) != 1:
            raise RuntimeError(f'{len(marks)} {MARKER} spans in the trace')
        mark = marks[0]
        self.start, self.end = mark.time_range.start, mark.time_range.end
        self.window_us = self.end - self.start
        self.thread = mark.thread
        self.host = [e for e in host if e is not mark
                     and e.time_range.start >= self.start
                     and e.time_range.end <= self.end]
        # the benchmark's spans come back as device annotations too
        self.device = [e for e in events
                       if e.device_type != DeviceType.CPU
                       and not e.name.startswith('bench::')
                       and self.start <= e.time_range.start < self.end]
        self.busy = _union([e.time_range.start,
                            min(e.time_range.end, self.end)]
                           for e in self.device)
        self.busy_us = sum(e - s for s, e in self.busy)
        kernels = collections.defaultdict(lambda: [0.0, 0])
        for e in self.device:
            kernels[e.name][0] += e.time_range.end - e.time_range.start
            kernels[e.name][1] += 1
        self.kernels = dict(kernels)

    # ------------------------------------------------------------------

    def idle_share(self):
        """1 - busy / window, or None when no device event was traced."""
        if not self.device:
            return None
        return 1.0 - self.busy_us / self.window_us

    def kernel_us(self, part: str) -> tuple:
        """(device us, launches) of the kernels whose name holds ``part``."""
        hits = [v for k, v in self.kernels.items() if part in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def op_us(self, ops) -> float:
        """Device time of the host operators named in ``ops`` (a name
        ending in ``_`` matches as a prefix), their children's included,
        as ``chip_smoke.profile_by_group`` sums it."""
        return sum(_device_us(e) for e in self.host
                   if any(e.name == op or (op.endswith('_')
                                           and e.name.startswith(op))
                          for op in ops))

    def span_us(self, name: str) -> float:
        """Device time launched under the benchmark's spans ``name``."""
        return self.op_us((name,))

    # ------------------------------------------------------------------

    def idle_gaps(self):
        """[(start, end)] of the window where no device operation ran."""
        gaps, t = [], self.start
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.end:
            gaps.append((t, self.end))
        return gaps

    def gap_labels(self, top: int = 10) -> list:
        """Idle seconds summed by what the host's measuring thread ran at
        each gap's middle: its outermost benchmark span and its innermost
        operator, 'span > op'."""
        main = sorted((e for e in self.host if e.thread == self.thread),
                      key=lambda e: e.time_range.start)
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] + g[1])
        totals = collections.defaultdict(float)
        active, i = [], 0
        for s, e in gaps:
            mid = (s + e) / 2
            while i < len(main) and main[i].time_range.start <= mid:
                ev = main[i]
                heapq.heappush(active, (ev.time_range.end, i, ev))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            here = [ev for _, _, ev in active]
            spans = [ev for ev in here if ev.name.startswith('bench::')]
            ops = [ev for ev in here if not ev.name.startswith('bench::')]
            outer = min(spans, key=lambda ev: ev.time_range.start).name \
                if spans else 'no span'
            inner = max(ops, key=lambda ev: ev.time_range.start).name \
                if ops else 'python'
            totals[f'{outer} > {inner}'] += (e - s) / 1e6
        return sorted(totals.items(), key=lambda kv: -kv[1])[:top]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k[:160], v[0] / 1e6) for k, v in self.kernels.items()),
                     key=lambda kv: -kv[1])[:top]
        return {'device_ops': [list(kv) for kv in ops],
                'idle_gaps': [list(kv) for kv in self.gap_labels(top)]}
