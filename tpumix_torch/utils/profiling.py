"""The port's tracing: program spans and counters, and trace capture.

* :func:`span` — a named phase of the program (a context manager);
* :func:`count` — a counter event (a name and a value);
* :func:`spans`, :func:`counts` — snapshots of what was recorded;
* :func:`carry` — a callable that records, on another thread, under the
  span and request it was made in;
* :func:`trace_to` — capture a trace of the enclosed region
  (``torch.profiler.profile`` with CPU and, where a card is present, CUDA
  activities), written into ``log_dir`` as a Chrome trace with the program's
  spans and counters beside the profiler's events; the profile is what the
  context yields, for ``key_averages()``.

Recording is on exactly while a ``torch.profiler`` session records (the
flag ``torch.autograd.profiler._is_profiler_enabled``, which every thread
sees).  Off, :func:`span` and :func:`count` read that flag and nothing else:
no clock, no record, no ``record_function``.  On, a span keeps its name,
its start and end on ``time.time_ns()`` (the clock of the profiler's host
events), its thread, its parent and its request: the id of the outermost
span it runs under, shared by every span and counter of one request or one
song, on the packer thread too.  A span's self time (its duration less what
its children cover) is left to the reader.  Spans are kept by the program, not as
``record_function`` ranges: those would reach the device trace as "gpu user
annotations" and count as device time.  Both buffers are bounded
(:data:`CAPACITY` records each, the oldest dropped first) and thread-safe.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 20

_clock = time.time_ns  # the profiler's host clock (epoch ns)


class Span(NamedTuple):
    """One recorded span; ``tid`` is the native thread id, as the
    profiler's host events carry it."""

    name: str
    start_ns: int
    end_ns: int
    tid: int
    id: int
    parent: Optional[int]
    request: int


class Count(NamedTuple):
    """One counter event; ``request`` is None outside any span."""

    name: str
    t_ns: int
    value: int
    request: Optional[int]


_SPANS: deque = deque(maxlen=CAPACITY)
_COUNTS: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)
# (span id, request id) of the innermost open span of this context
_current: contextvars.ContextVar[Optional[Tuple[int, int]]] = contextvars.ContextVar(
    "tpumix_span", default=None)
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "id", "parent", "request", "start", "token")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        outer = _current.get()
        self.id = next(_ids)
        self.parent, self.request = outer if outer is not None else (None, self.id)
        self.token = _current.set((self.id, self.request))
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = _clock()
        _current.reset(self.token)
        _SPANS.append(Span(self.name, self.start, end, threading.get_native_id(), self.id,
                           self.parent, self.request))
        return False


def span(name: str):
    """A named phase: ``with span("mixer.pack"): ...``.  Recorded only while
    a profiler session records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name)


def count(name: str, n: int) -> None:
    """Record the counter ``name`` at ``n`` under the current request, while
    a profiler session records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    outer = _current.get()
    _COUNTS.append(Count(name, _clock(), n, None if outer is None else outer[1]))


def carry(fn: Callable) -> Callable:
    """``fn``, to run on another thread under this thread's current span and
    request (a pool does not carry them); ``fn`` itself while off."""
    if not _autograd_profiler._is_profiler_enabled:
        return fn
    return functools.partial(contextvars.copy_context().run, fn)


def spans() -> List[Span]:
    """A snapshot of the recorded spans, in the order they ended."""
    return list(_SPANS)


def counts() -> List[Count]:
    """A snapshot of the recorded counter events, in order."""
    return list(_COUNTS)


def _write_program_events(path: str, began: int, ended: int) -> None:
    """Add the spans and counter events recorded in ``[began, ended]`` to
    the Chrome trace at ``path``, on its time base."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for s in spans():
        if began <= s.start_ns <= ended:
            events.append({"ph": "X", "cat": "tpumix", "name": s.name, "pid": pid,
                           "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
                           "dur": (s.end_ns - s.start_ns) / 1e3,
                           "args": {"id": s.id, "parent": s.parent, "request": s.request}})
    for c in counts():
        if began <= c.t_ns <= ended:
            events.append({"ph": "C", "cat": "tpumix", "name": c.name, "pid": pid,
                           "ts": (c.t_ns - base) / 1e3, "args": {"value": c.value}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Trace the enclosed region with ``torch.profiler`` into a Chrome trace
    ``log_dir/trace_<pid>_<time>.json`` that also holds the program's spans
    (category ``tpumix``); yields the profile."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    began = _clock()
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        ended = _clock()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _write_program_events(path, began, ended)
