"""The port's FLOP counter (tpumix_torch/models/flops.py, a copy of
tpumix/models/flops.py) equals the JAX package's; its recorder
(tpumix_torch/utils/profiling.py) records only while a profiler session
records, on the profiler's clock, and the mixer and the service record
their phases and chunk counters under one request, on the CPU."""

import glob
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tpumix.models.flops as jax_flops
import tpumix_torch.models.flops as flops
from tpumix_torch.config import MixConfig, preset
from tpumix_torch.infer.mixer import SongMixer
from tpumix_torch.models.registry import build_model
from tpumix_torch.serve import MixingService
from tpumix_torch.utils import profiling
from portbench.core import program_spans

SR = 44100
STEMS = ("bass", "drums", "vocals", "other")
PHASES = {"mixer.downmix", "mixer.pack", "mixer.dispatch", "mixer.collect", "mixer.epilogue"}


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling._SPANS.clear()
    profiling._COUNTS.clear()
    yield
    profiling._SPANS.clear()
    profiling._COUNTS.clear()


def _mixer(max_chunks):
    """scalar1sL (one-second chunks) from its initialisation, short segments."""
    torch.manual_seed(0)
    return SongMixer(build_model(preset("scalar1sL")), preset("scalar1sL"),
                     MixConfig(chunk_length_s=1.0, max_chunks=max_chunks), device="cpu")


def _tracks(seconds, channels=2):
    rng = np.random.default_rng(1)
    n = int(seconds * SR)
    return {t: (0.1 * rng.standard_normal((channels, n))).astype(np.float32) for t in STEMS}


def _named(records, name):
    return [r for r in records if r.name == name]


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




def test_recording_follows_the_profilers_flag():
    """On is exactly while a torch.profiler session records, on every
    thread: the Python flag the recorder reads is global, the C++ one is per
    thread."""
    flags = []

    def other_thread():
        flags.append((torch.autograd.profiler._is_profiler_enabled,
                      torch._C._autograd._profiler_enabled()))
        with profiling.span("other thread"):
            pass

    with profiling.span("before"):
        pass
    assert not torch.autograd.profiler._is_profiler_enabled
    with torch.profiler.profile():
        assert torch.autograd.profiler._is_profiler_enabled
        assert torch._C._autograd._profiler_enabled()
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert flags == [(True, False)]
    prof = torch.profiler.profile()
    prof.start()
    with profiling.span("started"):
        pass
    prof.stop()
    with profiling.span("after"):
        pass
    assert [s.name for s in profiling.spans()] == ["other thread", "started"]


def test_off_reads_no_clock_and_builds_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while no profiler records")

    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling.threading, "get_native_id", refuse)
    assert profiling.span("a") is profiling.span("b")  # one shared null context
    with profiling.span("a"):
        with profiling.span("b"):
            profiling.count("c", 3)
    fn = len
    assert profiling.carry(fn) is fn
    assert profiling.spans() == [] and profiling.counts() == []


def test_on_records_names_parents_requests_and_self_time(monkeypatch):
    ticks = iter([0, 10, 30, 40, 45, 50, 100, 200, 260, 300])
    with torch.profiler.profile():
        monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
        with profiling.span("root"):                  # 0 .. 100
            with profiling.span("a"):                 # 10 .. 30
                pass
            with profiling.span("b"):                 # 40 .. 50
                profiling.count("n", 5)               # 45
        with profiling.span("other"):                 # 200 .. 300
            profiling.count("n", 2)                   # 260
    monkeypatch.undo()
    got = {s.name: s for s in profiling.spans()}
    assert [s.name for s in profiling.spans()] == ["a", "b", "root", "other"]
    root, a, b, other = got["root"], got["a"], got["b"], got["other"]
    assert (root.start_ns, root.end_ns) == (0, 100)
    assert root.parent is None and a.parent == b.parent == root.id
    assert a.request == b.request == root.request == root.id
    assert other.parent is None and other.request == other.id != root.id
    assert {s.tid for s in got.values()} == {threading.get_native_id()}
    assert [(c.name, c.t_ns, c.value, c.request) for c in profiling.counts()] == [
        ("n", 45, 5, root.id), ("n", 260, 2, other.id)]
    own = program_spans.self_ns(profiling.spans())
    assert own == {a.id: 20, b.id: 10, root.id: 70, other.id: 100}


def test_self_time_counts_overlapping_children_once():
    def rec(i, parent, s, e, tid=1):
        return profiling.Span("x", s, e, tid, i, parent, 1)

    records = [rec(1, None, 0, 100), rec(2, 1, 10, 50), rec(3, 1, 30, 70, tid=2),
               rec(4, 1, 90, 120), rec(5, 2, 20, 25)]
    # children 2, 3, 4 cover [10, 70) and [90, 100) of the parent
    assert program_spans.self_ns(records) == {1: 30, 2: 35, 3: 40, 4: 30, 5: 5}


def test_buffers_are_bounded_and_snapshots_are_copies():
    assert profiling.CAPACITY == 2 ** 20
    assert profiling._SPANS.maxlen == profiling._COUNTS.maxlen == profiling.CAPACITY
    with torch.profiler.profile():
        with profiling.span("a"):
            pass
    snap = profiling.spans()
    snap.clear()
    assert [s.name for s in profiling.spans()] == ["a"]


def test_span_clock_is_the_profilers():
    """A span around a matmul overlaps the profiler's aten::matmul event and
    starts within 1 ms of it: both are on time.time_ns()."""
    assert profiling._clock is time.time_ns
    a, b = torch.ones(64, 64), torch.ones(64, 64)
    with torch.profiler.profile() as prof:
        with profiling.span("matmul"):
            torch.matmul(a, b)
    s = profiling.spans()[0]
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::matmul"]
    assert len(ev) == 1
    start, end = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    assert start < s.end_ns and s.start_ns < end
    assert abs(start - s.start_ns) < 1_000_000


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with profiling.trace_to(str(tmp_path)) as prof:
        with profiling.span("tpumix-region"):
            torch.matmul(torch.ones(16, 16), torch.ones(16, 16))
            profiling.count("tpumix-rows", 16)
    files = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        doc = json.load(f)
    events, base = doc["traceEvents"], doc["baseTimeNanoseconds"]
    s = profiling.spans()[0]
    (region,) = [e for e in events if e.get("name") == "tpumix-region"]
    assert region["cat"] == "tpumix" and region["ph"] == "X"
    assert region["ts"] == pytest.approx((s.start_ns - base) / 1e3, abs=1e-3)
    assert region["dur"] == pytest.approx((s.end_ns - s.start_ns) / 1e3, abs=1e-3)
    assert region["args"] == {"id": s.id, "parent": None, "request": s.id}
    assert region["tid"] == threading.get_native_id()
    (mm,) = [e for e in events if e.get("name") == "aten::matmul"]
    assert region["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= region["ts"] + region["dur"]
    (rows,) = [e for e in events if e.get("name") == "tpumix-rows"]
    assert rows["ph"] == "C" and rows["args"] == {"value": 16}
    # the span is the program's, not a profiler range: no device time counts it
    assert not any(e.key == "tpumix-region" for e in prof.key_averages())
    assert any(e.key == "aten::matmul" for e in prof.key_averages())


def test_song_mixer_counts_chunks_and_carries_the_song_to_the_packer():
    """Five gains in segments of 2 (2 + 2 + 1, packed on the packer thread):
    the counters read 5 real of 6 run, and every span and counter carries
    the song's request id."""
    mixer = _mixer(max_chunks=2)
    tracks = _tracks(6.5)
    with torch.profiler.profile():
        _, raw, _ = mixer.mix_song_smooth(tracks)
    n_gains = len(raw["bass"])
    assert n_gains == 5
    records = profiling.spans()
    (song,) = _named(records, "mixer.song")
    assert song.parent is None and {r.request for r in records} == {song.id}
    packs = _named(records, "mixer.pack")
    packer = {t.native_id for t in mixer._packer._threads}
    assert len(packs) == 3 and {p.tid for p in packs} == packer != {threading.get_native_id()}
    assert all(t.name.startswith("tpumix-pack") for t in mixer._packer._threads)
    assert all(p.parent == song.id for p in packs)
    assert len(_named(records, "mixer.dispatch")) == 3
    for name in ("mixer.downmix", "mixer.collect", "mixer.epilogue"):
        assert [r.parent for r in _named(records, name)] == [song.id]
    cs = profiling.counts()
    assert {c.request for c in cs} == {song.id}
    assert sum(c.value for c in cs if c.name == "mixer.chunks_real") == n_gains
    assert sum(c.value for c in cs if c.name == "mixer.chunks_run") == 3 * 2


def test_device_mixer_counts_chunks_under_its_song():
    mixer = _mixer(max_chunks=4)
    stems = np.stack([t[0] for t in _tracks(6.5).values()])
    with torch.profiler.profile():
        mixer.mix_song_smooth_device(stems)
    stage, song = profiling.spans()  # in the order they ended: the staging first
    assert song.name == "mixer.song" and song.parent is None
    assert stage.name == "mixer.stage" and stage.parent == song.id
    cs = profiling.counts()
    assert [(c.name, c.value) for c in cs] == [("mixer.chunks_real", 4), ("mixer.chunks_run", 4),
                                               ("mixer.chunks_real", 1), ("mixer.chunks_run", 4)]
    assert {c.request for c in cs} == {song.id}


def test_service_gains_holds_the_mixers_five_phases():
    """One request, one segment: service.gains is the root, the mixer's song
    its child, and the five phases tile the song inside it."""
    svc = MixingService(_mixer(max_chunks=4))
    with torch.profiler.profile():
        svc.gains(_tracks(3.5, channels=1))
    records = profiling.spans()
    (root,) = _named(records, "service.gains")
    (song,) = _named(records, "mixer.song")
    assert root.parent is None and song.parent == root.id
    phases = [r for r in records if r.parent == song.id]
    assert sorted(r.name for r in phases) == sorted(PHASES)
    assert {r.request for r in records} == {root.id}
    assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in records)
    order = [r.name for r in sorted(phases, key=lambda r: r.start_ns)]
    assert order == ["mixer.downmix", "mixer.pack", "mixer.dispatch", "mixer.collect",
                     "mixer.epilogue"]
    assert [(c.name, c.value) for c in profiling.counts()] == [("mixer.chunks_real", 2),
                                                               ("mixer.chunks_run", 4)]


def _run(t0, t1, traced=True):
    """What the benchmark's readers see of a run: its trace's window."""
    return SimpleNamespace(trace=SimpleNamespace(t0=t0, t1=t1) if traced else None)


def _record(name, start, end, parent=None, request=1):
    profiling._SPANS.append(profiling.Span(name, start, end, 1, len(profiling._SPANS) + 1,
                                           parent, request))


def test_program_span_readers_keep_the_window():
    """Records that start before t0 or after t1 are another window's."""
    for i, (lo, hi) in enumerate([(0, 50), (100, 300), (400, 600), (700, 800)]):
        _record("service.gains", lo, hi, request=i)
        _record("mixer.pack", lo + 10, lo + 30 + 10 * i, parent=i, request=i)
        profiling._COUNTS.append(profiling.Count("mixer.chunks_real", lo + 5, 9 + i, i))
        profiling._COUNTS.append(profiling.Count("mixer.chunks_run", lo + 5, 64, i))
    run = _run(100, 650)
    spans, counts = program_spans.records(run)
    assert {s.request for s in spans} == {c.request for c in counts} == {1, 2}
    # two requests: packs of 30 and 40 ns
    assert program_spans.per_request_ms(run, ["mixer.pack"]) == pytest.approx(35e-6)
    assert program_spans.counter_share(run, "mixer.chunks_real",
                                       "mixer.chunks_run") == 100.0 * 21 / 128


def test_program_span_readers_read_nothing_where_there_is_nothing(monkeypatch):
    """None, never 0: without a trace, for a program without the recorder,
    and for a window without the named spans or counters."""
    _record("service.gains", 10, 90)
    _record("mixer.collect", 20, 80, parent=1)
    assert program_spans.records(_run(0, 100, traced=False)) is None
    assert program_spans.per_request_ms(_run(0, 100), ["mixer.collect"]) == pytest.approx(60e-6)
    assert program_spans.per_request_ms(_run(0, 100), ["mixer.pack"]) is None
    assert program_spans.per_request_ms(_run(200, 300), ["mixer.collect"]) is None
    assert program_spans.counter_share(_run(0, 100), "mixer.chunks_real",
                                       "mixer.chunks_run") is None
    monkeypatch.delattr(profiling, "spans")
    assert program_spans.records(_run(0, 100)) is None
    assert program_spans.per_request_ms(_run(0, 100), ["mixer.collect"]) is None


def test_program_span_readers_raise_when_the_recorder_fails(monkeypatch):
    """A recorder that is there but broken is a fault, not a run without
    records."""
    monkeypatch.delattr(profiling, "counts")
    with pytest.raises(AttributeError):
        program_spans.records(_run(0, 100))

    def broken():
        raise RuntimeError("recorder failed")

    monkeypatch.setattr(profiling, "spans", broken)
    with pytest.raises(RuntimeError):
        program_spans.per_request_ms(_run(0, 100), ["mixer.pack"])
