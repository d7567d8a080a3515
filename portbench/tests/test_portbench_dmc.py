"""The session cell (16 tracks of the Differentiable Mixing Console) through
the whole harness at a tiny size on the CPU, and its frozen counts."""

import json
import os

import pytest
import torch
from conftest import BENCH, run_tiny, tiny_cell
from test_portbench_cells import altered, broken_gains

from portbench.core import weights
from portbench.reference import counts, families

CELL = "dmc_vggish.sessions16"


def config():
    with open(os.path.join(BENCH, "configs", "dmc_vggish.json")) as f:
        return json.load(f)


def test_traced_sound_run_is_correct():
    """Correct, and the traced line reads the program's counters and the
    staging span; on the CPU no device operation runs, so no roofline or
    idle share is made up."""
    line = run_tiny(tiny_cell(CELL), trace=True)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"mfu.sessions16", "useful_chunks.sessions16",
                                    "stage_ms.sessions16"}
    assert line["metrics"]["stage_ms.sessions16"]["value"] > 0


def test_broken_path_is_not_correct():
    with broken_gains(altered):
        line = run_tiny(tiny_cell(CELL))
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_counts_by_hand():
    cfg = config()
    layers, out = counts.trunk_layers(cfg)
    per_example = [f // 16 for _, f in layers]
    assert per_example == [7077888, 226492416, 226492416, 452984832, 226492416, 452984832,
                           100663296, 33554432, 1048576]
    assert sum(per_example) == 1727791104 and out == (128, 1, 1)
    assert counts.model_flops_per_chunk(cfg) == 16 * (1727791104 + 263168) == 27648868352
    assert counts.frontend_bytes_per_chunk(cfg) == 16 * (42336 + 96 * 64) * 4


def test_weights_are_the_programs_parameters():
    """Every name and shape the family draws is the program's, and VGGish
    holds its published 72,141,184 parameters."""
    from tpumix_torch.config import preset
    from tpumix_torch.models.registry import build_model

    cfg = config()
    shapes = families.of(cfg).param_shapes(cfg)
    model = build_model(preset(cfg["preset"]))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(s) for k, (s, _) in shapes.items()}
    vggish = sum(torch.Size(s).numel() for k, (s, _) in shapes.items()
                 if k.startswith("encoder."))
    assert vggish == 72141184


@pytest.mark.parametrize("kind,std", [("relu_weight", (2 / 12288) ** 0.5),
                                      ("weight", 4096 ** -0.5)])
def test_seeded_weight_scales(kind, std):
    cfg = config()
    w = weights.make(cfg, 2**31 + 7, "cpu")
    name = "encoder.fc1_1.weight" if kind == "relu_weight" else "encoder.fc2.weight"
    assert float(w[name].std()) == pytest.approx(std, rel=0.02)
    assert torch.equal(w["post.act1.weight"], torch.full((1,), 0.25))
