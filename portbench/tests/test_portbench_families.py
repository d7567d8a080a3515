"""Everything of the yardstick that depends on the model is found by the
configuration's ``family``: a new family is a new module and entries alone,
a family without a module fails loudly, and so does a weight kind that
nobody makes."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, ROOT, SEED

from portbench.core import weights
from portbench.core.harness import RunError
from portbench.reference import counts, families, models, pipeline

#: run in a copy of the checkout, with the copy's own harness and families
RUN_IN_COPY = """
import json, sys
from conftest import run_tiny, tiny_cell
import portbench
from portbench.reference import counts
new, old = sys.argv[1:]
line = run_tiny(tiny_cell(new))
def count(cfg):
    return [counts.model_flops_per_chunk(cfg), counts.frontend_bytes_per_chunk(cfg),
            counts.trunk_layers(cfg)]
print(json.dumps({"correct": line["correct"], "checks": line["checks"],
                  "portbench": portbench.__file__,
                  "loaded": sorted(m for m in sys.modules if ".families." in m),
                  "new": count(tiny_cell(new).config), "old": count(tiny_cell(old).config)}))
"""


def copy_checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def test_new_family_is_a_module_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a family (the scalar module under a new
    name), a configuration that names it with the scalar2s preset, and a
    cell, by new files and entries only; the copy's harness runs the cell
    correct, through the new module, with scalar2s's counts."""
    root = copy_checkout(tmp_path)
    pb = root / "portbench"
    fam = pb / "reference" / "families"
    (fam / "scalar_copy.py").write_text((fam / "scalar.py").read_text())
    cfg = json.loads((pb / "configs" / "scalar2s.json").read_text())
    cfg.update(name="scalar2s_copy", family="scalar_copy")
    assert cfg["preset"] == "scalar2s"
    (pb / "configs" / "scalar2s_copy.json").write_text(json.dumps(cfg))
    (pb / "limits" / "scalar2s_copy.songs.json").write_text(
        (pb / "limits" / "scalar2s.songs.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "scalar2s_copy", "source": cfg["source"],
                             "file": "portbench/configs/scalar2s_copy.json", "reduced": [],
                             "why": "a test family"})
    bench["workloads"].append({"name": "scalar2s_copy.songs", "config": "scalar2s_copy",
                               "traffic": "songs", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("scalar2s_copy.songs")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    path = os.pathsep.join([str(pb / "tests"), str(root), ROOT])
    got = subprocess.run([sys.executable, "-c", RUN_IN_COPY, "scalar2s_copy.songs",
                          "scalar2s.songs"], cwd=root, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=path), timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["portbench"].startswith(str(root))
    assert "portbench.reference.families.scalar_copy" in out["loaded"]
    assert out["correct"], out["checks"]
    assert out["new"] == out["old"]


def test_unknown_family_exits_1_and_names_it(tmp_path):
    root = copy_checkout(tmp_path)
    path = root / "portbench" / "configs" / "scalar2s.json"
    cfg = json.loads(path.read_text())
    cfg["family"] = "no_such_family"
    path.write_text(json.dumps(cfg))
    got = subprocess.run([sys.executable, "portbench/run.py", "--workload", "scalar2s.songs",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert got.returncode == 1
    assert got.stdout == ""
    assert "no_such_family" in got.stderr
    assert all(f in got.stderr for f in families.available())


@pytest.mark.parametrize("call", [
    lambda cfg: models.param_shapes(cfg),
    lambda cfg: models.gains({}, torch.zeros(1, 4, 8, 8), cfg),
    lambda cfg: counts.trunk_layers(cfg),
    lambda cfg: counts.model_flops_per_chunk(cfg),
    lambda cfg: counts.frontend_bytes_per_chunk(cfg),
    lambda cfg: pipeline.song({}, torch.zeros(4, 3 * cfg["chunk_samples"]).numpy(), cfg, "cpu"),
    lambda cfg: pipeline.clip({}, torch.zeros(4, 3 * cfg["chunk_samples"]).numpy(), cfg, "cpu"),
    lambda cfg: weights.make(cfg, SEED, "cpu"),
], ids=["param_shapes", "gains", "trunk_layers", "model_flops", "frontend_bytes", "song",
        "clip", "weights"])
@pytest.mark.parametrize("family", ["no_such_family", "__init__", None])
def test_no_routed_call_falls_back_to_a_family(call, family):
    cfg = json.load(open(os.path.join(BENCH, "configs", "scalar2s.json")))
    cfg["family"] = family
    with pytest.raises(RunError) as e:
        call(cfg)
    assert e.value.code == 1 and repr(family) in str(e.value)


def scalar2s():
    cfg = json.load(open(os.path.join(BENCH, "configs", "scalar2s.json")))
    return cfg, families.of(cfg)


def test_unknown_weight_kind_raises(monkeypatch):
    cfg, fam = scalar2s()
    shapes = fam.param_shapes(cfg)
    shapes["extra.scale"] = ((3,), "mystery")
    monkeypatch.setattr(fam, "param_shapes", lambda cfg: shapes)
    with pytest.raises(RunError, match="'mystery'"):
        weights.make(cfg, SEED, "cpu")


def test_a_family_makes_its_own_weight_kinds(monkeypatch):
    cfg, fam = scalar2s()
    shapes = fam.param_shapes(cfg)
    shapes["extra.scale"] = ((3,), "mystery")
    monkeypatch.setattr(fam, "param_shapes", lambda cfg: shapes)
    monkeypatch.setattr(fam, "KINDS", {"mystery": lambda x, shape, wcfg: 2.0 + 0.0 * x},
                        raising=False)
    w = weights.make(cfg, SEED, "cpu")
    assert torch.equal(w["extra.scale"], torch.full((3,), 2.0))


def outside_the_families():
    for d, _, files in os.walk(BENCH):
        rel = os.path.relpath(d, BENCH)
        if rel.startswith("tests") or rel.startswith(os.path.join("reference", "families")):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_outside_the_families_names_a_family():
    """No string of a family's name, and no comparison with a config's
    ``family``, outside ``reference/families/`` (and the tests)."""
    names = set(families.available())
    for path in outside_the_families():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant):
                assert node.value not in names, (path, node.lineno)
            if isinstance(node, ast.Compare):
                text = ast.unparse(node)
                assert "'family'" not in text and '"family"' not in text, (path, node.lineno)
