"""Service requests for short clips: ``MixingService.gains``, the call that
``/gains`` makes once the body is decoded, on a service built and warmed as
``serve`` builds it, without the socket.  One client in a closed loop with
no think time; stems are handed as the body decoder hands them, a dict of
``[1, S]`` float32 arrays.

The window opens at the first call; no call starts once ``--seconds`` have
passed, and the window closes when the last one returns.  Every answer of
the window is kept and checked: the reference computes each distinct clip
once.
"""

from __future__ import annotations

import time
from typing import Dict

from portbench.core import program, signals
from portbench.core.harness import Window
from portbench.reference import counts, pipeline

STEMS = ("bass", "drums", "vocals", "other")


def setup(ctx) -> Dict:
    cfg, tr = ctx.config, ctx.traffic
    lengths = signals.lengths_s(tr["lengths"])
    sd = ctx.seeds
    clips = signals.host_items(lengths, tr["audio"], sd["audio"], ctx.device)
    ctx.mark("inputs")
    weights = program.weights(cfg, sd["weights"], clips[-1], ctx.device)
    ctx.mark("weights")
    program.reset_peak(ctx.device)
    service = program.service(cfg, weights, ctx.device, ctx.overrides)
    ctx.mark("program and warm-up")
    bodies = [{t: c[i][None, :] for i, t in enumerate(STEMS)} for c in clips]
    order = signals.order(len(clips), tr["lengths"]["strata"], sd["order"])
    program.sync(ctx.device)
    return {"clips": clips, "bodies": bodies, "order": order, "weights": weights,
            "service": service}


def window(state, ctx) -> Window:
    service, bodies, order = state["service"], state["bodies"], state["order"]
    C = ctx.config["chunk_samples"]
    sr = ctx.traffic["audio"]["sample_rate"]
    span = ctx.tracer.span
    items, answers = [], []
    with ctx.tracer.window():
        start = time.perf_counter()
        deadline = start + ctx.seconds
        i = 0
        while time.perf_counter() < deadline:
            idx = order[i % len(order)]
            t0 = time.perf_counter()
            with span("pb.request"):
                raw, smooth = service.gains(bodies[idx])
            t1 = time.perf_counter()
            S = state["clips"][idx].shape[-1]
            items.append({"index": i, "clip": idx, "audio_s": S / sr, "n_gains": S // C - 1,
                          "latency_s": t1 - t0})
            answers.append((idx, raw, smooth))
            i += 1
        end = time.perf_counter()
    state["answers"] = answers
    return Window(end - start, items, attempted=len(items), failed=0,
                  extra={"model_flops_per_chunk": counts.model_flops_per_chunk(ctx.config)})


def peak_bytes(state, ctx) -> int:
    return program.peak_bytes(ctx.device)


def release(state, ctx) -> Dict:
    program.free(state.pop("service"), ctx.device)
    return {"clips": state["clips"], "weights": state["weights"], "answers": state["answers"]}


def outputs(kept, ctx, tf32: bool = False) -> Dict[int, tuple]:
    """The reference's ``(raw, smoothed)`` amplitude gains of every clip
    answered, in full float32 or (the control) in TF32."""
    pipeline.precision(tf32)
    try:
        return {idx: pipeline.clip(kept["weights"], kept["clips"][idx], ctx.config, ctx.device)
                for idx in sorted({a[0] for a in kept["answers"]})}
    finally:
        pipeline.precision(False)


def _rows(answer: Dict) -> list:
    return [answer[t] for t in STEMS]


def compare(kept, ref: Dict[int, tuple]) -> Dict[str, float]:
    raw_err = smooth_err = 0.0
    for idx, raw, smooth in kept["answers"]:
        r_raw, r_smooth = ref[idx]
        raw_err = max(raw_err, pipeline.rel_err(_rows(raw), r_raw))
        smooth_err = max(smooth_err, pipeline.rel_err(_rows(smooth), r_smooth))
    return {"raw_err": raw_err, "smooth_err": smooth_err}


def check(kept, ctx) -> Dict[str, float]:
    return compare(kept, outputs(kept, ctx))


def substitute(kept, ref: Dict[int, tuple]) -> Dict:
    """``kept`` with every answer replaced by ``ref``'s for its clip (the
    control in the program's place)."""
    out = dict(kept)
    out["answers"] = [(idx, dict(zip(STEMS, ref[idx][0])), dict(zip(STEMS, ref[idx][1])))
                      for idx, _, _ in kept["answers"]]
    return out
