"""The resnet family (deep-audio-mixer models/model_resnet.py): the scalar
family's features, heads and epilogue behind a ResNet trunk: a k3 pad-1
stem conv -> BN -> ReLU, then BasicBlocks (conv3x3(stride) -> BN -> ReLU ->
conv3x3 -> BN, plus a 1x1 strided projection -> BN where the shape changes,
-> ReLU)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import counts, frontend, models, pipeline

features = frontend.chunk_features
song, clip = pipeline.mono_song, pipeline.mono_clip
model_flops_per_chunk = counts.mono_model_flops
frontend_bytes_per_chunk = counts.stft_frontend_bytes


def trunk_layers(cfg: Dict) -> Tuple[List[Tuple[str, int]], Tuple[int, int, int]]:
    """Per-conv FLOPs of one item through the stem and stages (k3 pad 1
    convolutions, 1x1 projection shortcuts), and the output."""
    h, w = cfg["n_fft"] // 2 + 1, counts.frames(cfg["chunk_samples"], cfg["hop_length"])
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


def param_shapes(cfg: Dict):
    shapes: OrderedDict = OrderedDict()
    c_in = cfg["num_stems"]
    stem = cfg["stem_width"]
    shapes["stem_conv.weight"] = ((stem, c_in, 3, 3), "weight")
    models.bn_shapes(shapes, "stem_bn", stem)
    c_in = stem
    for si, (n, width, stride) in enumerate(cfg["stages"], start=1):
        for b in range(1, n + 1):
            p = f"layer{si}_block{b}"
            shapes[f"{p}.conv1.weight"] = ((width, c_in, 3, 3), "weight")
            models.bn_shapes(shapes, f"{p}.bn1", width)
            shapes[f"{p}.conv2.weight"] = ((width, width, 3, 3), "weight")
            models.bn_shapes(shapes, f"{p}.bn2", width)
            if (stride if b == 1 else 1) != 1 or c_in != width:
                shapes[f"{p}.shortcut_conv.weight"] = ((width, c_in, 1, 1), "weight")
                models.bn_shapes(shapes, f"{p}.shortcut_bn", width)
            c_in = width
    _, (c, h, w) = trunk_layers(cfg)
    models.head_shapes(shapes, cfg, c, h * w)
    return shapes


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
            calibrate: bool = False) -> torch.Tensor:
    net = models.Net(w, cfg["bn_eps"], calibrate)
    h = torch.relu(net.bn(F.conv2d(x, w["stem_conv.weight"], padding=1), "stem_bn"))
    for si, (n, _, stride) in enumerate(cfg["stages"], start=1):
        for b in range(1, n + 1):
            p = f"layer{si}_block{b}"
            s = stride if b == 1 else 1
            out = torch.relu(net.bn(F.conv2d(h, w[f"{p}.conv1.weight"], stride=s, padding=1),
                                    f"{p}.bn1"))
            out = net.bn(F.conv2d(out, w[f"{p}.conv2.weight"], padding=1), f"{p}.bn2")
            if f"{p}.shortcut_conv.weight" in w:
                h = net.bn(F.conv2d(h, w[f"{p}.shortcut_conv.weight"], stride=s),
                           f"{p}.shortcut_bn")
            h = torch.relu(out + h)
    return net.heads(h, cfg["num_stems"])

