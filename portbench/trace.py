"""Host spans and the device trace of a run.

`Spans` keeps the benchmark's own spans in memory: a name, a start and an
end on the wall clock (`time.time_ns`), the clock of the profiler's
events, so that a gap on the device can be named by the span the host was
in. `DeviceTrace` profiles the card with `torch.profiler` (CUDA activity
only, so that no CPU operator is recorded and the host runs as it does
untraced) and keeps every device operation's interval: kernels, copies and
fills. Nothing is exported to disk.
"""

from __future__ import annotations

import bisect
import collections
import re
import time

import torch


class Spans:
    def __init__(self):
        self.records: list[tuple[str, int, int]] = []

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        self.records.append((name, start_ns, end_ns))

    def durations_s(self, name: str) -> list[float]:
        return [(e - s) / 1e9 for n, s, e in self.records if n == name]


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without `void `, anonymous namespaces and its
    argument list, cut to width; copies' and fills' names as they are."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:width]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


def names_kernel(pattern: str, name: str) -> bool:
    """Whether a device operation's name has `pattern` as a whole
    identifier."""
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(pattern)}(?![A-Za-z0-9_])",
                     name) is not None


class DeviceTrace:
    """`with DeviceTrace() as tr:` profiles the device over the block; after
    it, `tr.ops` holds (name, start_ns, end_ns) of every device operation
    clipped to the window [tr.start_ns, tr.end_ns], which begins and ends
    with the device idle."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        cuda = torch.autograd.DeviceType.CUDA
        self.ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            s, t = max(e.start_ns(), self.start_ns), min(
                e.start_ns() + e.duration_ns(), self.end_ns)
            if t > s:
                self.ops.append((e.name(), s, t))
        self._prof = None
        return False

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union([(s, e) for _, s, e in self.ops])) / 1e9

    def seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.ops:
            out[name] += (e - s) / 1e9
        return dict(out)

    def idle_by_span(self, spans: Spans) -> dict[str, float]:
        """Seconds of the window with no device operation, by the innermost
        host span in which each gap began ("no span" outside all)."""
        busy = _union([(s, e) for _, s, e in self.ops])
        gaps, cur = [], self.start_ns
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.end_ns > cur:
            gaps.append((cur, self.end_ns))
        recs = sorted((s, e, n) for n, s, e in spans.records
                      if e > self.start_ns and s < self.end_ns)
        starts = [r[0] for r in recs]
        out: dict[str, float] = collections.defaultdict(float)
        for g0, g1 in gaps:
            label, width = "no span", None
            # Spans that begin at or before the gap; the host's spans nest
            # or follow each other, so a few dozen back cover it.
            i = bisect.bisect_right(starts, g0)
            for s, e, n in recs[max(0, i - 32) : i]:
                if e > g0 and (width is None or e - s < width):
                    label, width = n, e - s
            out[label] += (g1 - g0) / 1e9
        return dict(out)
