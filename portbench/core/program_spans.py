"""The program's own spans and counters inside a ``--trace 1`` run's window.

``tpumix_torch.utils.profiling`` records them while a profiler session
records, on the profiler's clock (``time.time_ns()``), so the records that
start between the trace's ``t0`` and ``t1`` are the window's.  This is the
one module of the benchmark that reads them.  A reading is None where there
is nothing to read: a run without a trace, a program without the recorder
(one whose ``profiling`` module has no ``spans``), or a window that holds
none of the spans or counters the metric names.  A recorder that is there
but fails raises.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

#: the span each request of a service cell opens
REQUEST = "service.gains"


def records(run) -> Optional[Tuple[List, List]]:
    """``(spans, counter events)`` that start inside the traced window."""
    if run.trace is None:
        return None
    from tpumix_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans, counts = profiling.spans(), profiling.counts()
    t0, t1 = run.trace.t0, run.trace.t1
    return ([s for s in spans if t0 <= s.start_ns <= t1],
            [c for c in counts if t0 <= c.t_ns <= t1])


def per_request_ms(run, names: Iterable[str]) -> Optional[float]:
    """Summed duration of the spans named ``names`` over the number of
    requests (``service.gains`` spans) in the window, in ms."""
    got = records(run)
    if got is None:
        return None
    names = set(names)
    spans = got[0]
    n = sum(1 for s in spans if s.name == REQUEST)
    timed = [s.end_ns - s.start_ns for s in spans if s.name in names]
    if n == 0 or not timed:
        return None
    return sum(timed) * 1e-6 / n


def counter_share(run, part: str, whole: str) -> Optional[float]:
    """100 x the summed counter ``part`` over the summed counter ``whole``
    in the window, in %."""
    got = records(run)
    if got is None:
        return None
    counts = got[1]
    den = sum(c.value for c in counts if c.name == whole)
    if den <= 0:
        return None
    return 100.0 * sum(c.value for c in counts if c.name == part) / den


def self_ns(spans: Iterable) -> Dict[int, int]:
    """Each span's self time, by id: its duration less the union of its
    children's intervals inside it (children may overlap across threads)."""
    spans = list(spans)
    by_id = {s.id: s for s in spans}
    kids: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for s in spans:
        p = by_id.get(s.parent)
        if p is not None:
            lo, hi = max(s.start_ns, p.start_ns), min(s.end_ns, p.end_ns)
            if hi > lo:
                kids[p.id].append((lo, hi))
    out = {}
    for s in spans:
        covered, reach = 0, None
        for lo, hi in sorted(kids[s.id]):
            if reach is None or lo > reach:
                covered += hi - lo
                reach = hi
            elif hi > reach:
                covered += hi - reach
                reach = hi
        out[s.id] = s.end_ns - s.start_ns - covered
    return out
