"""The device trace of a ``--trace 1`` run and what the readers take from it.

``torch.profiler`` (CUPTI) records every device operation (kernels, copies,
sets) and the benchmark's own host spans (``record_function`` names that
start with ``pb.``).  The traced window is the ``pb.window`` span.  Busy
time is the union of the device operations' intervals inside it; an idle
gap is named by the innermost ``pb.`` span open on the host at its start.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "pb.window"


def _merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """Device operations ``(name, start_ns, end_ns)`` and host spans of one
    process's traced window."""

    def __init__(self, ops: List[Tuple[str, int, int]], spans: List[Tuple[str, int, int]]):
        windows = [s for s in spans if s[0] == WINDOW]
        if not windows:
            raise RuntimeError("the trace holds no pb.window span")
        _, self.t0, self.t1 = windows[0]
        self.ops = [(n, max(s, self.t0), min(e, self.t1)) for n, s, e in ops
                    if e > self.t0 and s < self.t1]
        self.spans = sorted((s for s in spans if s[0] != WINDOW), key=lambda s: s[1])
        self._starts = [s for _, s, _ in self.spans]
        self.busy = _merge((s, e) for _, s, e in self.ops)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        ops, spans = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.name().startswith("pb."):
                # a host span; its device-side copy (a "gpu user
                # annotation") is no device operation
                if e.device_type() != DeviceType.CUDA:
                    spans.append((e.name(), start, end))
            elif e.device_type() == DeviceType.CUDA:
                ops.append((e.name(), start, end))
        return cls(ops, spans)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def seconds(self, pattern: str) -> float:
        """Summed time of the device operations whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(n)) * 1e-9

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for name, s, e in self.ops:
            by[name] += e - s
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: int) -> str:
        """The innermost benchmark span open at ``t`` (the latest started)."""
        i = bisect.bisect_right(self._starts, t)
        while i > 0:
            i -= 1
            name, _, e = self.spans[i]
            if e > t:
                return name
        return "host.outside_spans"

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle time inside the window, summed by what the host was doing."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        by: Dict[str, int] = defaultdict(int)
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                by[self._host_at(s)] += e - s
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def summary(self) -> Dict:
        return {"window_s": self.window_s, "busy_s": self.busy_s,
                "device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


class Tracer:
    """A profiler around the window when tracing, nothing otherwise; spans
    go into the trace as ``record_function`` ranges."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.trace: Optional[Trace] = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                yield
        self.prof = prof

    def reduce(self) -> Optional[Trace]:
        if self.prof is not None and self.trace is None:
            self.trace = Trace.from_profiler(self.prof)
            self.prof = None
        return self.trace
