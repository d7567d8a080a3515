"""The frozen counts, pinned to the figures worked out by hand."""

import json
import os

import pytest

from portbench.reference import counts

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_scalar2s_trunk_per_segment():
    cfg = config("scalar2s")
    layers, (c, h, w) = counts.scalar_trunk_layers(cfg)
    assert (c, h * w) == (128, 30807)  # the reference's pinned flatten size
    gflop = [64 * f / 1e9 for _, f in layers]  # per 64-chunk segment
    assert gflop == pytest.approx([3.2, 67.3, 190.4, 679.9, 2616.6], abs=0.6)
    assert 64 * counts.trunk_flops_per_chunk(cfg) / 1e12 == pytest.approx(3.557, abs=5e-4)


def test_resnet18_trunk_per_segment():
    cfg = config("resnet18")
    _, (c, h, w) = counts.resnet_trunk_layers(cfg)
    assert (c, h, w) == (256, 33, 7)  # flattened head dim 231
    assert counts.trunk_flops_per_chunk(cfg) / 1e9 == pytest.approx(15.764, abs=1e-3)
    assert 64 * counts.trunk_flops_per_chunk(cfg) / 1e12 == pytest.approx(1.009, abs=5e-4)


def test_heads_are_a_sliver():
    for name in ("scalar2s", "resnet18"):
        cfg = config(name)
        assert counts.heads_flops_per_chunk(cfg) < 1e-2 * counts.trunk_flops_per_chunk(cfg)
        assert counts.model_flops_per_chunk(cfg) == (
            counts.trunk_flops_per_chunk(cfg) + counts.heads_flops_per_chunk(cfg))


def test_k1_bytes_per_segment():
    cfg = config("scalar2s")
    # [64, 4, 88200] float32 in, [64, 4, 173, 1025] float32 out
    assert 64 * counts.frontend_bytes_per_chunk(cfg) == 64 * 4 * (88200 + 173 * 1025) * 4
    assert 64 * counts.frontend_bytes_per_chunk(cfg) / 1e6 == pytest.approx(271.9, abs=0.05)
    assert counts.frontend_bytes(1, 220500, config("resnet18")) == (220500 + 216 * 1025) * 4


def test_training_convention():
    cfg = config("scalar2s")
    assert counts.TRAIN_PASSES == 3
    assert counts.train_flops_per_row(cfg) == 3 * counts.model_flops_per_chunk(cfg)


def test_pinned_flatten_guard():
    cfg = dict(config("scalar2s"), trunk=[[16, 3, 2], [32, 5, 1], [48, 5, 1], [64, 7, 1],
                                          [128, 7, 1]])
    with pytest.raises(AssertionError):
        counts.scalar_trunk_layers(cfg)
