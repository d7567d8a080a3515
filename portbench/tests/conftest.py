"""Tiny cells for the CPU: the cells' own configurations at their published
widths, with short songs and clips, two-chunk segments and one calibration
chunk, run through the whole harness with the kernels' plain versions."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core.harness import Cell, run_cell  # noqa: E402

SEED = 2**31 + 7  # larger than 32 signed bits hold, as the driver's are


def shrink(cell: Cell) -> Cell:
    cell.config["weights"]["calibration_chunks"] = 1
    chunk_s = cell.config["chunk_samples"] / cell.config["sample_rate"]
    cell.traffic["lengths"] = {"distribution": "uniform", "min_s": 3.2 * chunk_s,
                               "max_s": 4.8 * chunk_s, "quantiles": 4, "strata": 2}
    if "check" in cell.traffic:
        cell.traffic["check"]["sampled"] = 2
    return cell


def tiny_cell(name: str, root: str = ROOT) -> Cell:
    return shrink(Cell.find(name, root))


def run_tiny(cell: Cell, trace: bool = False, seed: int = SEED, **overrides) -> dict:
    return run_cell(cell, seed, 1.0, trace, device="cpu",
                    overrides={"max_chunks": 2, **overrides})


@pytest.fixture
def card():
    """The card, for the tests marked ``cuda``; they skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
