"""The device trace of a traced run, reduced to what the per-layer metrics
and the result's ``breakdown`` read: the device's kernels and copies inside
the measured window, the union of their intervals (so that overlapping
kernels count once), and the host's activity in the gaps between them."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

WINDOW = "portbench.window"


@contextlib.contextmanager
def profiled(enabled: bool):
    """``torch.profiler`` over the block (CPU and CUDA activities) when
    ``enabled``; yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


@dataclass
class Trace:
    start_ns: int
    end_ns: int
    #: (name, start ns, duration ns) of every device kernel, copy and set
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    #: (name, start ns, end ns) of every host event
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def merged(self) -> List[Tuple[int, int]]:
        """The union of the device intervals, clipped to the window."""
        spans = sorted((max(s, self.start_ns), min(s + d, self.end_ns)) for _, s, d in self.device)
        out: List[List[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def device_time_s(self, match) -> float:
        """Summed device time of the events whose name ``match`` accepts."""
        return sum(d for name, _, d in self.device if match(name)) / 1e9

    def kernel_count(self) -> int:
        return sum(1 for name, _, _ in self.device if not name.startswith("Memcpy")
                   and not name.startswith("Memset"))

    def device_ops(self, n: int = 10) -> List[list]:
        totals: Dict[str, int] = {}
        for name, _, d in self.device:
            totals[name] = totals.get(name, 0) + d
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], d / 1e9] for name, d in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest intervals of the window in which nothing ran on
        the device, each named by the innermost host event covering its
        middle."""
        gaps, last = [], self.start_ns
        for s, e in self.merged():
            if s > last:
                gaps.append((last, s))
            last = e
        if self.end_ns > last:
            gaps.append((last, self.end_ns))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for s, e in gaps:
            mid = (s + e) // 2
            best = None
            for name, hs, he in host[:bisect.bisect_right(starts, mid)]:
                if he >= mid and (best is None or hs >= best[1]):
                    best = (name, hs)
            out.append([best[0][:200] if best else "none", (e - s) / 1e9])
        return out


def reduce(prof) -> Trace:
    """The events of ``prof`` inside the host span named :data:`WINDOW`."""
    events = list(prof.profiler.kineto_results.events())
    window = [e for e in events if e.name() == WINDOW and str(e.device_type()).endswith("CPU")]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w = window[0]
    trace = Trace(w.start_ns(), w.start_ns() + w.duration_ns())
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if start + dur < trace.start_ns or start > trace.end_ns:
            continue
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                trace.device.append((e.name(), start, dur))
        elif e.name() != WINDOW:
            trace.host.append((e.name(), start, start + dur))
    return trace
