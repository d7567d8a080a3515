"""Each cell's traffic through the whole harness at a tiny size on the CPU,
against the reference: a sound run is correct, and a run with the timed
path broken underneath is not.  The control (the reference in TF32 in the
program's place) runs on the card only."""

import contextlib

import pytest
import torch
from conftest import SEED, run_tiny, tiny_cell

CELLS = ("scalar2s.songs", "resnet18.songs", "scalar2s.clips")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell = tiny_cell(name)
    line = run_tiny(cell)
    assert list(line) == KEYS + ["checks"]  # the numbers compared come last
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in cell.metrics(False)}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_run_reports_the_trace_keys():
    cell = tiny_cell("scalar2s.clips")
    line = run_tiny(cell, trace=True)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no device operation runs: no roofline or idle share is made
    # up; the program's spans and counters are recorded on the host
    assert set(line["metrics"]) == {"mfu.clips", "pack_ms.clips", "epilogue_ms.clips",
                                    "device_wait_ms.clips", "useful_chunks.clips"}


@contextlib.contextmanager
def broken_gains(fault):
    """Break the mixer's timed path where the gains are produced."""
    from tpumix_torch.infer.mixer import SongMixer

    original = SongMixer._gains_fn

    def gains_fn(self, flat, n_chunks, scales=None):
        return fault(original(self, flat, n_chunks, scales))

    SongMixer._gains_fn = gains_fn
    try:
        yield
    finally:
        SongMixer._gains_fn = original


def altered(g):
    """One answer altered where it is produced."""
    g = g.clone()
    g[0, 0] += 0.05
    return g


def half_left_out(g):
    """Half of the segment's chunks left out, the mean taken over the rest."""
    g = g.clone()
    h = g.shape[0] // 2
    g[h:] = g[:h].mean(dim=0)
    return g


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [altered, half_left_out], ids=["altered", "half"])
def test_broken_path_is_not_correct(name, fault):
    with broken_gains(fault):
        line = run_tiny(tiny_cell(name))
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_same_seed_same_inputs():
    from portbench.core import signals

    tr = tiny_cell("scalar2s.songs").traffic
    a = signals.host_items([1.0], tr["audio"], SEED, "cpu")[0]
    b = signals.host_items([1.0], tr["audio"], SEED, "cpu")[0]
    c = signals.host_items([1.0], tr["audio"], SEED + 1, "cpu")[0]
    assert (a == b).all() and not (a == c).all()
    assert signals.order(16, 4, SEED) == signals.order(16, 4, SEED)
    assert sorted(signals.order(16, 4, SEED)) == list(range(16))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card):
    """The reference in TF32 in the program's place fails a limit."""
    from portbench.core.harness import Context, judge, is_correct
    from portbench.core.trace import Tracer

    cell = tiny_cell(name)
    driver = cell.driver()
    ctx = Context(cell, SEED, 1.0, Tracer(False), card, {"max_chunks": 2})
    state = driver.setup(ctx)
    driver.window(state, ctx)
    kept = driver.release(state, ctx)
    ref = driver.outputs(kept, ctx)
    control = driver.compare(driver.substitute(kept, driver.outputs(kept, ctx, tf32=True)), ref)
    assert not is_correct(judge(control, cell.limits()))
    assert torch.backends.cudnn.allow_tf32 is False
