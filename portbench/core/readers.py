"""What the metric files share: each ``metrics/<name>.py`` reads one number
of a run with one of these.  A reader that finds nothing to read returns
None, and the metric is left out of the line; a share of a roofline or a
peak is never made up as 0."""

from __future__ import annotations

import statistics
from typing import Optional

from portbench.reference import counts, kernels


def setup_s(run) -> float:
    return run.setup_s


def rate(run, key: str) -> Optional[float]:
    """Sum of ``key`` over the window's items, over the window's seconds."""
    if not run.items or run.window_s <= 0:
        return None
    return sum(it[key] for it in run.items) / run.window_s


def percentile_ms(run, key: str, q: int) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics) of ``key``
    over every item of the window, in ms."""
    vals = [it[key] for it in run.items]
    if len(vals) < 2:
        return None
    return statistics.quantiles(vals, n=100, method="inclusive")[q - 1] * 1e3


def mean_ms(run, key: str) -> Optional[float]:
    vals = [it[key] for it in run.items if key in it]
    return statistics.fmean(vals) * 1e3 if vals else None


def _real_chunks(run) -> int:
    return sum(it["n_gains"] for it in run.items)


def _share(bound_s: float, took_s: float) -> Optional[float]:
    return 100.0 * bound_s / took_s if took_s > 0 and bound_s > 0 else None


def k1_roofline(run) -> Optional[float]:
    """K1's byte bound over the real chunks at the HBM peak, over K1's
    summed kernel time, in %."""
    if run.trace is None:
        return None
    moved = _real_chunks(run) * run.extra["frontend_bytes_per_chunk"]
    return _share(moved / counts.PEAK_HBM_BYTES, run.trace.seconds(kernels.K1))


def trunk_roofline(run) -> Optional[float]:
    """Model FLOPs of the real chunks at the dense TF32 peak, over the
    summed time of the trunk's and heads' kernels, in %."""
    if run.trace is None:
        return None
    flops = _real_chunks(run) * run.extra["model_flops_per_chunk"]
    return _share(flops / counts.PEAK_TF32_FLOPS, run.trace.seconds(kernels.TRUNK))


def mfu(run) -> Optional[float]:
    """Model FLOPs of the window's real work over window seconds x chips x
    the dense TF32 peak, in %."""
    if run.trace is None or not run.items:
        return None
    flops = _real_chunks(run) * run.extra["model_flops_per_chunk"]
    return _share(flops / (run.cell.chips * counts.PEAK_TF32_FLOPS), run.window_s)


def device_idle(run) -> Optional[float]:
    """Share of the traced window in which no device operation ran, in %."""
    if run.trace is None:
        return None
    s = run.trace.summary()
    if s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
