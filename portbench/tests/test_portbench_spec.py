"""``BENCHMARK.json`` keeps the benchmark's contract, and the harness finds
every configuration, traffic mix, metric and limit by name, so that a new
one is added as files and entries alone."""

import json
import os
import re
import shutil

import pytest
from conftest import ROOT, run_tiny, shrink

from portbench.core import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_and_entry_keys(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_limits(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_is_whole(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        cell = harness.Cell.find(w["name"])
        reported = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.metrics(True), w["name"]
        assert os.path.exists(os.path.join(cell.dir, "limits", f"{w['name']}.json"))
        assert os.path.exists(os.path.join(cell.dir, "drivers", f"{cell.traffic['driver']}.py"))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", []):
            assert c in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or c in moved["workloads"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", f"{m['name']}.py"))


def test_configs_state_their_reductions(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert c["file"].startswith("portbench/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["precision"] == "float32" and cfg["tf32"] is False


def test_metric_selection_per_run():
    cell = harness.Cell.find("scalar2s.clips")
    assert [m["name"] for m in cell.metrics(False)] == ["clip_p90_ms", "setup_s"]
    traced = {m["name"] for m in cell.metrics(True)}
    assert traced == {"trunk_roofline.clips", "mfu.clips", "device_idle.clips"}


def test_new_config_traffic_and_metric_are_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric and a cell by new files and new entries only; the harness runs
    the new cell and reads the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "scalar2s.json").read_text())
    cfg.update(name="scalar2s_hop", conv_impl="xla")
    (pb / "configs" / "scalar2s_hop.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "songs.json").read_text())
    traffic["depth"] = 1
    (pb / "traffic" / "songs_serial.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "songs_done.py").write_text(
        "def read(run):\n    return float(len(run.items))\n")
    (pb / "limits" / "scalar2s_hop.songs_serial.json").write_text(
        (pb / "limits" / "scalar2s.songs.json").read_text())
    bench["configs"].append({"name": "scalar2s_hop", "source": cfg["source"],
                             "file": "portbench/configs/scalar2s_hop.json", "reduced": [],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "scalar2s_hop.songs_serial", "config": "scalar2s_hop",
                               "traffic": "songs_serial", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "songs_done", "unit": "songs", "better": "higher",
                               "source": "host_clock", "layer": "mixer host side",
                               "moves": "mix_rate", "workloads": ["scalar2s_hop.songs_serial"]})
    bench["end_to_end"][0]["workloads"].append("scalar2s_hop.songs_serial")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = shrink(harness.Cell.find("scalar2s_hop.songs_serial", str(root)))
    assert cell.traffic["depth"] == 1 and cell.config["name"] == "scalar2s_hop"
    line = run_tiny(cell, trace=True)
    assert line["correct"]
    assert line["metrics"]["songs_done"]["value"] == line["attempted"]
