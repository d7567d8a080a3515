"""The scalar family (deep-audio-mixer models/model_scalar_1s.py and
model_scalar_2s.py): dB STFT features of the stems as input channels, five
VALID ConvBlocks (conv + bias -> BatchNorm -> ReLU), block 1 with the
configuration's stride and dilation, then the scalar heads: one gain a stem
and chunk, amplitudes ``10**(0.5 g)``, Savitzky-Golay, mono mixdown.

The trunk's count is a copy of the arithmetic of the port's
``models/flops.py``, held to the reference model's pinned flatten sizes
(10290 = 490 x 21 at 87 frames, dilation 1; 30807 = 489 x 63 at 173 frames,
dilation 2).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import counts, frontend, models, pipeline

_PINNED_FLATTEN = {(1, 87): 10290, (2, 173): 30807}

features = frontend.chunk_features
song, clip = pipeline.mono_song, pipeline.mono_clip
model_flops_per_chunk = counts.mono_model_flops
frontend_bytes_per_chunk = counts.stft_frontend_bytes


def trunk_layers(cfg: Dict) -> Tuple[List[Tuple[str, int]], Tuple[int, int, int]]:
    """Per-conv FLOPs of one ``[stems, bins, frames]`` item through the
    trunk, and the trunk's output ``(channels, H, W)``."""
    h, w = cfg["n_fft"] // 2 + 1, counts.frames(cfg["chunk_samples"], cfg["hop_length"])
    frames_in = w
    c_in = cfg["num_stems"]
    out = []
    for i, (c_out, k, s) in enumerate(cfg["trunk"]):
        d = cfg["block1_dilation"] if i == 0 else 1
        h, w = counts.valid(h, k, s, d), counts.valid(w, k, s, d)
        out.append((f"conv{i + 1}", 2 * h * w * c_out * k * k * c_in))
        c_in = c_out
    pinned = _PINNED_FLATTEN.get((cfg["block1_dilation"], frames_in))
    if pinned is not None and h * w != pinned:
        raise AssertionError(f"trunk shape arithmetic drifted: {h}x{w} != {pinned}")
    return out, (c_in, h, w)


def param_shapes(cfg: Dict):
    shapes: OrderedDict = OrderedDict()
    c_in = cfg["num_stems"]
    for i, (c_out, k, _) in enumerate(cfg["trunk"], start=1):
        shapes[f"conv_b{i}.conv.weight"] = ((c_out, c_in, k, k), "weight")
        shapes[f"conv_b{i}.conv.bias"] = ((c_out,), "bias")
        models.bn_shapes(shapes, f"conv_b{i}.bn", c_out)
        c_in = c_out
    _, (c, h, w) = trunk_layers(cfg)
    models.head_shapes(shapes, cfg, c, h * w)
    return shapes


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
            calibrate: bool = False) -> torch.Tensor:
    net = models.Net(w, cfg["bn_eps"], calibrate)
    h = x
    for i, (_, _, s) in enumerate(cfg["trunk"], start=1):
        d = cfg["block1_dilation"] if i == 1 else 1
        h = F.conv2d(h, w[f"conv_b{i}.conv.weight"], w[f"conv_b{i}.conv.bias"],
                     stride=s, dilation=d)
        h = torch.relu(net.bn(h, f"conv_b{i}.bn"))
    return net.heads(h, cfg["num_stems"])

