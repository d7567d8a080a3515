"""Whole-song mixing: ``SongMixer.mix_song_smooth_device``, what ``mix
--device-mix`` runs per song, driven by one closed-loop client that
dispatches ahead (``depth`` songs in flight, as ``mix_catalog``'s
``prefetch=2``): song k+1 is dispatched before song k's mix ``[S]`` and
smoothed curves are copied to the host.

The window opens at the first dispatch; no song is dispatched once
``--seconds`` have passed, and the window closes when the last one
dispatched has reached the host, so every song in it is counted whole.
Set-up runs one whole cycle of the songs in the window's order and depth,
so every song length's shapes are met and the card is at its steady pace
before the window opens.  Outputs kept for the check: ``check.sampled``
songs drawn from the seed, the longest length's first song, and the
window's last song.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict

import numpy as np

from portbench.core import program, signals
from portbench.core.harness import Window
from portbench.reference import counts, pipeline


def setup(ctx) -> Dict:
    cfg, tr = ctx.config, ctx.traffic
    lengths = signals.lengths_s(tr["lengths"])
    sd = ctx.seeds
    songs = signals.host_items(lengths, tr["audio"], sd["audio"], ctx.device)
    ctx.mark("inputs")
    weights = program.weights(cfg, sd["weights"], songs[0], ctx.device)
    ctx.mark("weights")
    program.reset_peak(ctx.device)
    mixer = program.mixer(cfg, weights, ctx.device, ctx.overrides)
    order = signals.order(len(songs), tr["lengths"]["strata"], sd["order"])
    ctx.mark("program")
    inflight: deque = deque()
    for n, idx in enumerate(order, 1):
        inflight.append(mixer.mix_song_smooth_device(songs[idx]))
        while len(inflight) >= tr["depth"] or (n == len(order) and inflight):
            out = inflight.popleft()
            out[1].cpu(), out[2].cpu()
    program.sync(ctx.device)
    ctx.mark("warm-up")
    rng = np.random.default_rng(sd["sample"])
    keep = set(int(i) for i in rng.choice(len(songs), size=tr["check"]["sampled"], replace=False))
    keep.add(order.index(len(songs) - 1))  # the longest length's first song
    return {"songs": songs, "order": order, "weights": weights,
            "mixer": mixer, "keep": keep}


def window(state, ctx) -> Window:
    mixer, songs, order = state["mixer"], state["songs"], state["order"]
    depth = ctx.traffic["depth"]
    C = ctx.config["chunk_samples"]
    span = ctx.tracer.span
    kept: Dict[int, tuple] = {}
    items = []
    inflight: deque = deque()

    def collect():
        i, idx, out, t0, t1 = inflight.popleft()
        with span("pb.collect"):
            mix = out[1].cpu().numpy()
            curves = out[2].cpu().numpy()
        done = time.perf_counter()
        S = songs[idx].shape[-1]
        items.append({"index": i, "song": idx, "audio_s": S / ctx.traffic["audio"]["sample_rate"],
                      "n_gains": S // C - 1, "dispatch_s": t1 - t0, "done": done})
        if i in state["keep"]:
            kept[i] = (idx, mix, curves)
        state["last"] = (i, idx, mix, curves)

    with ctx.tracer.window():
        start = time.perf_counter()
        deadline = start + ctx.seconds
        i = 0
        while time.perf_counter() < deadline:
            idx = order[i % len(order)]
            t0 = time.perf_counter()
            with span("pb.dispatch"):
                out = mixer.mix_song_smooth_device(songs[idx])
            inflight.append((i, idx, out, t0, time.perf_counter()))
            i += 1
            if len(inflight) >= depth:
                collect()
        while inflight:
            collect()
        end = time.perf_counter()
    last = state.pop("last")
    kept.setdefault(last[0], last[1:])
    state["kept"] = kept
    for it in items:
        it["done"] -= start
    return Window(end - start, items, attempted=len(items), failed=0,
                  extra={"frontend_bytes_per_chunk": counts.frontend_bytes_per_chunk(ctx.config),
                         "model_flops_per_chunk": counts.model_flops_per_chunk(ctx.config)})


def peak_bytes(state, ctx) -> int:
    return program.peak_bytes(ctx.device)


def release(state, ctx) -> Dict:
    program.free(state.pop("mixer"), ctx.device)
    return {"songs": state["songs"], "weights": state["weights"], "kept": state["kept"]}


def outputs(kept, ctx, tf32: bool = False) -> Dict[int, tuple]:
    """The reference's ``(curves, mix)`` of every kept song, in full float32
    or (the control) in TF32."""
    pipeline.precision(tf32)
    try:
        return {i: pipeline.song(kept["weights"], kept["songs"][idx], ctx.config, ctx.device)
                for i, (idx, _, _) in kept["kept"].items()}
    finally:
        pipeline.precision(False)


def compare(kept, ref: Dict[int, tuple]) -> Dict[str, float]:
    curve_err = mix_err = 0.0
    for i, (_, mix, curves) in kept["kept"].items():
        r_curves, r_mix = ref[i]
        curve_err = max(curve_err, pipeline.rel_err(curves, r_curves))
        mix_err = max(mix_err, pipeline.rel_err(mix[None], r_mix[None]))
    return {"curve_err": curve_err, "mix_err": mix_err}


def check(kept, ctx) -> Dict[str, float]:
    return compare(kept, outputs(kept, ctx))


def substitute(kept, ref: Dict[int, tuple]) -> Dict:
    """``kept`` with the program's outputs replaced by ``ref``'s (the
    control in the program's place)."""
    out = dict(kept)
    out["kept"] = {i: (idx, ref[i][1].astype(np.float32), ref[i][0].astype(np.float32))
                   for i, (idx, _, _) in kept["kept"].items()}
    return out
