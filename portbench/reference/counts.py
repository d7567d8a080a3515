"""Frozen operation and byte counts: the yardstick of every roofline and
``mfu`` metric.

FLOPs are 2 per multiply-add of the convolutions and dense layers, worked
out from a configuration's shapes alone; BatchNorm, ReLU, the residual adds
and the frontend are not counted, so a rate read against them is a floor.
The scalar trunk's count is a copy of the arithmetic of the port's
``models/flops.py``, held to the reference model's pinned flatten sizes
(10290 = 490 x 21 at 87 frames, dilation 1; 30807 = 489 x 63 at 173 frames,
dilation 2).  Training counts a step as three forward passes (the backward
as twice the forward), the common convention.

The frontend kernel's bytes are the least it has to move: each input sample
read once and each float32 feature written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

#: dense peaks of one NVIDIA H100 SXM (data sheet, 700 W)
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

#: forward + backward of a training step, in forward passes
TRAIN_PASSES = 3

_PINNED_FLATTEN = {(1, 87): 10290, (2, 173): 30807}


def frames(chunk_samples: int, hop: int) -> int:
    """Frame count of one centre-padded chunk (``1 + S // hop``)."""
    return 1 + chunk_samples // hop


def _valid(n: int, k: int, s: int, d: int) -> int:
    return (n - (d * (k - 1) + 1)) // s + 1


def scalar_trunk_layers(cfg: Dict) -> Tuple[List[Tuple[str, int]], Tuple[int, int, int]]:
    """Per-conv FLOPs of one ``[stems, bins, frames]`` item through the
    scalar trunk, and the trunk's output ``(channels, H, W)``."""
    h, w = cfg["n_fft"] // 2 + 1, frames(cfg["chunk_samples"], cfg["hop_length"])
    frames_in = w
    c_in = cfg["num_stems"]
    out = []
    for i, (c_out, k, s) in enumerate(cfg["trunk"]):
        d = cfg["block1_dilation"] if i == 0 else 1
        h, w = _valid(h, k, s, d), _valid(w, k, s, d)
        out.append((f"conv{i + 1}", 2 * h * w * c_out * k * k * c_in))
        c_in = c_out
    pinned = _PINNED_FLATTEN.get((cfg["block1_dilation"], frames_in))
    if pinned is not None and h * w != pinned:
        raise AssertionError(f"trunk shape arithmetic drifted: {h}x{w} != {pinned}")
    return out, (c_in, h, w)


def resnet_trunk_layers(cfg: Dict) -> Tuple[List[Tuple[str, int]], Tuple[int, int, int]]:
    """Per-conv FLOPs of one item through the ResNet stem and stages
    (k3 pad 1 convolutions, 1x1 projection shortcuts), and the output."""
    h, w = cfg["n_fft"] // 2 + 1, frames(cfg["chunk_samples"], cfg["hop_length"])
    c_in = cfg["num_stems"]
    stem = cfg["stem_width"]
    out = [("stem", 2 * h * w * stem * 9 * c_in)]
    c_in = stem
    for si, (n, width, stride) in enumerate(cfg["stages"], start=1):
        for b in range(1, n + 1):
            s = stride if b == 1 else 1
            h, w = (h - 1) // s + 1, (w - 1) // s + 1
            f = 2 * h * w * width * 9 * c_in + 2 * h * w * width * 9 * width
            if s != 1 or c_in != width:
                f += 2 * h * w * width * c_in
            out.append((f"layer{si}_block{b}", f))
            c_in = width
    return out, (c_in, h, w)


def trunk_layers(cfg: Dict):
    return (resnet_trunk_layers if cfg["family"] == "resnet" else scalar_trunk_layers)(cfg)


def trunk_flops_per_chunk(cfg: Dict) -> int:
    return sum(f for _, f in trunk_layers(cfg)[0])


def heads_flops_per_chunk(cfg: Dict) -> int:
    """The scalar heads: a 1x1 conv to one channel and a dense layer over
    the flattened map, one per stem."""
    _, (c, h, w) = trunk_layers(cfg)
    return cfg["num_stems"] * (2 * h * w * c + 2 * h * w)


def model_flops_per_chunk(cfg: Dict) -> int:
    """Forward FLOPs of one chunk: trunk and heads."""
    return trunk_flops_per_chunk(cfg) + heads_flops_per_chunk(cfg)


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
    return frontend_bytes(cfg["num_stems"], cfg["chunk_samples"], cfg)
