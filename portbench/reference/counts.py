"""Frozen operation and byte counts: the yardstick of every roofline and
``mfu`` metric.  The count of each family's model is in
``families/<family>.py``; the peaks and the arithmetic the families share
are here, and ``trunk_layers``, ``model_flops_per_chunk`` and
``frontend_bytes_per_chunk`` go through the family that the configuration
names.

FLOPs are 2 per multiply-add of the convolutions and dense layers, worked
out from a configuration's shapes alone; BatchNorm, ReLU, the residual adds
and the frontend are not counted, so a rate read against them is a floor.
Training counts a step as three forward passes (the backward as twice the
forward), the common convention.

The frontend kernel's bytes are the least it has to move: each input sample
read once and each float32 feature written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.reference import families

#: dense peaks of one NVIDIA H100 SXM (data sheet, 700 W)
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: forward + backward of a training step, in forward passes
TRAIN_PASSES = 3


def frames(chunk_samples: int, hop: int) -> int:
    """Frame count of one centre-padded chunk (``1 + S // hop``)."""
    return 1 + chunk_samples // hop


def valid(n: int, k: int, s: int, d: int) -> int:
    """Output length of a VALID convolution of kernel ``k``, stride ``s``,
    dilation ``d`` over ``n``."""
    return (n - (d * (k - 1) + 1)) // s + 1


def trunk_layers(cfg: Dict) -> Tuple[List[Tuple[str, int]], Tuple[int, int, int]]:
    """Per-layer FLOPs of one chunk through the family's trunk, and the
    trunk's output ``(channels, H, W)``."""
    return families.of(cfg).trunk_layers(cfg)


def trunk_flops_per_chunk(cfg: Dict) -> int:
    return sum(f for _, f in trunk_layers(cfg)[0])


def heads_flops(num_heads: int, c: int, h: int, w: int) -> int:
    """Scalar heads over a ``(c, h, w)`` map: a 1x1 conv to one channel and
    a dense layer over the flattened map, each."""
    return num_heads * (2 * h * w * c + 2 * h * w)


def heads_flops_per_chunk(cfg: Dict) -> int:
    """The model's FLOPs after its trunk: the heads."""
    return model_flops_per_chunk(cfg) - trunk_flops_per_chunk(cfg)


def model_flops_per_chunk(cfg: Dict) -> int:
    """Forward FLOPs of one chunk: trunk and heads."""
    return families.of(cfg).model_flops_per_chunk(cfg)


def train_flops_per_row(cfg: Dict) -> int:
    """Forward and backward FLOPs of one training row."""
    return TRAIN_PASSES * model_flops_per_chunk(cfg)


def frontend_bytes(signals: int, samples: int, cfg: Dict) -> int:
    """Least bytes of the dB frontend over ``signals`` float32 signals of
    ``samples`` each: read once, ``[frames, bins]`` float32 written once."""
    bins = cfg["n_fft"] // 2 + 1
    return signals * (samples * 4 + frames(samples, cfg["hop_length"]) * bins * 4)


def frontend_bytes_per_chunk(cfg: Dict) -> int:
    """The frontend's bytes for one chunk of every stem."""
    return families.of(cfg).frontend_bytes_per_chunk(cfg)


def mono_model_flops(cfg: Dict) -> int:
    """A family's ``model_flops_per_chunk`` where its trunk feeds one scalar
    head a stem: the trunk's FLOPs and the heads'."""
    layers, (c, h, w) = trunk_layers(cfg)
    return sum(f for _, f in layers) + heads_flops(cfg["num_stems"], c, h, w)


def stft_frontend_bytes(cfg: Dict) -> int:
    """A family's ``frontend_bytes_per_chunk`` where its input is the dB STFT
    of every stem's chunk."""
    return frontend_bytes(cfg["num_stems"], cfg["chunk_samples"], cfg)


def __getattr__(name: str):
    """``<family>_trunk_layers``: that family's ``trunk_layers``."""
    family = name[:-len("_trunk_layers")] if name.endswith("_trunk_layers") else ""
    if family and family in families.available():
        return families.of({"family": family}).trunk_layers
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
