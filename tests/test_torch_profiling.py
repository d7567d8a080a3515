"""The port's FLOP counter (tpumix_torch/models/flops.py, a copy of
tpumix/models/flops.py) equals the JAX package's, and its profiling helpers
(tpumix_torch/utils/profiling.py) keep tpumix/utils/profiling.py's
contracts on the CPU."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import tpumix.models.flops as jax_flops
import tpumix_torch.models.flops as flops
from tpumix_torch.utils import profiling


@pytest.mark.parametrize("dilation,frames", [(1, 87), (2, 173), (1, 47), (2, 60)])
def test_trunk_flops_are_the_jax_packages(dilation, frames):
    assert (flops.trunk_layer_flops(dilation, frames)
            == jax_flops.trunk_layer_flops(dilation, frames))
    assert (flops.trunk_flops_per_item(dilation, frames)
            == jax_flops.trunk_flops_per_item(dilation, frames))
    assert flops.TRUNK_SPECS == jax_flops.TRUNK_SPECS


def test_pinned_flatten_guard_fires(monkeypatch):
    assert flops._PINNED_FLATTEN == jax_flops._PINNED_FLATTEN
    monkeypatch.setitem(flops._PINNED_FLATTEN, (2, 173), 1)
    with pytest.raises(AssertionError, match="drifted"):
        flops.trunk_layer_flops(2, 173)
    per_item = flops.trunk_flops_per_item(1, 87)  # other keys still hold
    assert per_item > 0


def test_measure_throughput_is_best_of_reps_on_new_inputs():
    seen, times = [], iter([0.5, 0.2, 0.4, 0.3, 0.6])

    def fn(x, n):
        seen.append(x.clone())
        return x * n

    out = profiling.measure_throughput(fn, (torch.arange(8, dtype=torch.float32), 3),
                                       audio_seconds=12.0, reps=3, warmup=2)
    assert len(seen) == 2 + 3
    # warm-ups roll by -1, -2; the timed reps see rolls 1, 2, 3: all differ
    rolled = [tuple(s.tolist()) for s in seen]
    assert len(set(rolled)) == 5
    assert rolled[2] == tuple(torch.roll(torch.arange(8.0), 1).tolist())
    assert set(out) == {"seconds", "audio_s_per_s"}
    assert out["audio_s_per_s"] == pytest.approx(12.0 / out["seconds"])
    del times

    made = []
    out = profiling.measure_throughput(lambda a: a.sum(), (None,), audio_seconds=1.0, reps=4,
                                       warmup=1, make_args=lambda r: (made.append(r) or
                                                                      torch.full((3,), r),))
    assert made == [-1, 1, 2, 3, 4]
    assert out["seconds"] > 0


def test_measure_throughput_takes_the_fastest_rep(monkeypatch):
    ticks = iter([0.0, 5.0, 10.0, 12.0, 20.0, 23.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    out = profiling.measure_throughput(lambda x: x, (np.zeros(3, np.float32),), 4.0, reps=3,
                                       warmup=0)
    assert out == {"seconds": 2.0, "audio_s_per_s": 2.0}


def test_stopwatch_sections_accumulate():
    sw = profiling.Stopwatch()
    for _ in range(2):
        with sw.section("a", block_on=torch.ones(2)):
            pass
    with sw.section("b", block_on=lambda: {"x": torch.ones(1)}):
        pass
    assert set(sw.sections) == {"a", "b"} and all(v >= 0 for v in sw.sections.values())
    report = sw.report().splitlines()
    assert [line.split(":")[0] for line in report] == ["a", "b"]
    assert profiling.force({"x": torch.ones(2), "y": (torch.zeros(1),)})["y"][0].shape == (1,)


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with profiling.trace_to(str(tmp_path)) as prof:
        with profiling.annotate("tpumix-region"):
            torch.matmul(torch.ones(16, 16), torch.ones(16, 16))
    files = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "tpumix-region" for e in events)
    assert any(e.key == "tpumix-region" for e in prof.key_averages())
