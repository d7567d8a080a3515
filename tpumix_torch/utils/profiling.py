"""Tracing and timing helpers (tpumix/utils/profiling.py).

* :func:`annotate` — a named region in the profiler's timeline
  (``torch.profiler.record_function``);
* :func:`trace_to` — capture a trace of the enclosed region
  (``torch.profiler.profile`` with CPU and, where a card is present, CUDA
  activities), written into ``log_dir`` as a Chrome trace; the profile is
  what the context yields, for ``key_averages()``;
* :class:`Stopwatch` — named wall-clock sections that wait for the device;
* :func:`force` — copy a result to the host;
* :func:`measure_throughput` — best-of-``reps`` audio-seconds per second
  with a warm-up and per-rep inputs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import numpy as np
import torch


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Trace the enclosed region with ``torch.profiler`` into a Chrome trace
    ``log_dir/trace_<pid>_<time>.json``; yields the profile."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _synchronize(result) -> None:
    """Wait for the device of every CUDA tensor in ``result`` (a tensor or a
    tuple, list or dict of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _synchronize(v)


class Stopwatch:
    """Accumulates named wall-clock sections; waits for device results."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        """Time the enclosed block; with ``block_on`` (tensors, or a callable
        returning them), the section ends when their device is done."""
        tic = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on() if callable(block_on) else block_on)
            self.sections[name] = self.sections.get(name, 0.0) + time.perf_counter() - tic

    def report(self) -> str:
        total = sum(self.sections.values())
        return "\n".join(f"{k}: {v:.3f}s ({100 * v / max(total, 1e-9):.0f}%)"
                         for k, v in self.sections.items())


def force(result):
    """Copy a result (a tensor, or a tuple, list or dict of them) to the host
    as numpy arrays: the copy waits for the device."""
    if isinstance(result, torch.Tensor):
        return result.detach().cpu().numpy()
    if isinstance(result, dict):
        return {k: force(v) for k, v in result.items()}
    if isinstance(result, (tuple, list)):
        return type(result)(force(v) for v in result)
    return result


def measure_throughput(fn: Callable, args: tuple, audio_seconds: float, reps: int = 5,
                       warmup: int = 1, make_args: Callable[[int], tuple] = None
                       ) -> Dict[str, float]:
    """Best-of-``reps`` audio-seconds per second for ``fn(*args)``.

    Each rep runs ``fn`` and copies its result to the host, so asynchronous
    launches are fully counted.  Every rep sees other bytes: ``make_args(rep)``
    supplies its inputs; without it, every floating array or tensor argument
    is rolled by ``rep`` along its flattened order (the statistics are kept).
    Rep ``k + 1``'s inputs are made after rep ``k``'s timed window, so at most
    two copies of the arguments are alive.  Returns ``{"seconds": best,
    "audio_s_per_s": rate}``."""

    def _perturb(a, rep: int):
        if isinstance(a, np.ndarray) and a.dtype.kind == "f":
            return np.roll(a, rep)
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return torch.roll(a, rep)
        return a

    def _args_for(rep: int) -> tuple:
        if make_args is not None:
            return make_args(rep)
        if rep == 0:
            return args
        return tuple(_perturb(a, rep) for a in args)

    def _ready(a: tuple) -> tuple:
        _synchronize(a)  # a roll on the card must not run inside the timed window
        return a

    for w in range(warmup):
        force(fn(*_args_for(-1 - w)))
    best = float("inf")
    current = _ready(_args_for(1))
    for rep in range(reps):
        tic = time.perf_counter()
        force(fn(*current))
        best = min(best, time.perf_counter() - tic)
        if rep + 1 < reps:
            current = _ready(_args_for(rep + 2))
    return {"seconds": best, "audio_s_per_s": audio_seconds / best}
