"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``BENCHMARK.json`` names the cell's configuration and
traffic; ``configs/<config>.json`` and ``traffic/<traffic>.json`` hold their
data; the traffic's ``driver`` names a module ``drivers/<driver>.py``;
``limits/<cell>.json`` holds the limits of the numbers compared; every
metric is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

#: top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "tpumix")


class RunError(Exception):
    """A run that cannot print a result; ``code`` is its exit code."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def process_start() -> float:
    """This process's start on the wall clock (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise RunError(1, f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration and traffic."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    bench: Dict
    dir: str = BENCH  # the benchmark's folder, where its files are found

    @classmethod
    def find(cls, name: str, root: str = ROOT) -> "Cell":
        path = os.path.join(root, "BENCHMARK.json")
        if not os.path.exists(path):
            raise RunError(1, f"no BENCHMARK.json at {root}")
        bench = load_json(path)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise RunError(1, f"unknown workload {name!r}; have {sorted(cells)}")
        w = cells[name]
        cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        config = load_json(os.path.join(root, cfg_entry["file"]))
        folder = os.path.join(root, os.path.basename(BENCH))
        traffic = load_json(os.path.join(folder, "traffic", f"{w['traffic']}.json"))
        return cls(name, w["chips"], config, traffic, bench, folder)

    def metrics(self, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones, in ``BENCHMARK.json``'s order."""
        e2e = [m for m in self.bench["end_to_end"]
               if "workloads" not in m or self.name in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}

        def applies(m: Dict) -> bool:
            return self.name in m["workloads"] if "workloads" in m else m["moves"] in names

        return [m for m in self.bench["per_layer"] if applies(m)]

    def limits(self) -> Dict[str, float]:
        return load_json(os.path.join(self.dir, "limits", f"{self.name}.json"))

    def driver(self):
        name = self.traffic["driver"]
        return load_module(os.path.join(self.dir, "drivers", f"{name}.py"),
                           f"portbench_driver_{name}")


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, the run's seed and window, the
    tracer, and the device.  ``overrides`` is for the tests only: program
    options at sizes a CPU can hold."""

    cell: Cell
    seed: int
    seconds: float
    tracer: Any
    device: Any
    overrides: Dict = dataclasses.field(default_factory=dict)
    marks: List = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Note that the set-up phase ``phase`` has just ended."""
        self.marks.append((phase, time.time()))

    @property
    def config(self) -> Dict:
        return self.cell.config

    @property
    def traffic(self) -> Dict:
        return self.cell.traffic

    @property
    def seeds(self) -> Dict[str, int]:
        from portbench.core.signals import seeds

        return seeds(self.seed)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    items: List[Dict]
    attempted: int
    failed: int
    trace: Any = None  # this process's Trace, or None
    extra: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Window:
    """A driver's measured window."""

    window_s: float
    items: List[Dict]
    attempted: int
    failed: int
    extra: Dict = dataclasses.field(default_factory=dict)


def read_metrics(run: Run, metrics: List[Dict]) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        reader = load_module(os.path.join(run.cell.dir, "metrics", f"{m['name']}.py"),
                             f"portbench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise RunError(1, f"no limit for {missing}")
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def is_correct(checks: Dict[str, Dict]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device=None,
             overrides: Optional[Dict] = None, started: Optional[float] = None,
             driver=None, marks: Optional[List] = None) -> Dict:
    """One whole run; returns the result line as a dict (``checks`` last).
    ``device`` and ``overrides`` are for the tests; a run on the chip takes
    ``cuda`` and the files' sizes."""
    import torch

    from portbench.core.trace import Tracer

    started = process_start() if started is None else started
    driver = cell.driver() if driver is None else driver
    device = torch.device("cuda" if device is None else device)
    ctx = Context(cell, seed, seconds, Tracer(trace), device, dict(overrides or {}),
                  list(marks or []))
    ctx.mark("harness")
    state = driver.setup(ctx)
    window_t0 = time.time()
    setup_s = window_t0 - started
    ctx.marks.insert(0, ("process", started))
    phases = " ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(ctx.marks, ctx.marks[1:]))
    print(f"[setup] {setup_s:.3f} s: {phases} s", file=sys.stderr)
    win: Window = driver.window(state, ctx)
    found = forbidden_modules()
    if found:
        raise RunError(4, f"modules loaded in the measuring process: {found}")
    peak = driver.peak_bytes(state, ctx)
    kept = driver.release(state, ctx)
    t = ctx.tracer.reduce()
    run = Run(cell, setup_s, win.window_s, win.items, win.attempted, win.failed, t,
              win.extra)
    metrics = read_metrics(run, cell.metrics(trace))
    checks = judge(driver.check(kept, ctx), cell.limits())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    line: Dict[str, Any] = {"correct": is_correct(checks) and win.failed == 0,
                            "attempted": win.attempted, "failed": win.failed,
                            "metrics": metrics, "device": dev}
    if t is not None:
        s = t.summary()
        dev["busy_s"], dev["window_s"] = s["busy_s"], s["window_s"]
        line["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    found = forbidden_modules()
    if found:
        raise RunError(4, f"modules loaded in the measuring process: {found}")
    line["checks"] = checks
    return line


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: List[str], started: float, emit: Callable[[str], None] = print) -> int:
    args = parse(argv)
    try:
        cell = Cell.find(args.workload)
        import torch

        imported = time.time()
        if not torch.cuda.is_available():
            raise RunError(2, "no CUDA device is available")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(2, f"{args.workload} needs {cell.chips} cards, "
                              f"{torch.cuda.device_count()} present")
        try:
            import tpumix_torch  # noqa: F401
        except ImportError as e:
            raise RunError(3, f"the program (tpumix_torch) is not importable here: {e}")
        marks = [("import torch", imported), ("cuda and the program", time.time())]
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace), started=started,
                        marks=marks)
    except RunError as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return e.code
    for k, c in line["checks"].items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    emit(json.dumps(line))
    return 0
