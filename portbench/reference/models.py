"""Plain forward passes of the gain models, from a weight dict, in float32
with ``torch.nn.functional`` only (deep-audio-mixer models/model_scalar_2s.py
and models/model_resnet.py).

The parameter names follow the published flax/torch module names, which
the port's modules also use, so the benchmark's seeded weights load into
the program by name (``load_state_dict(strict=True)`` checks that both sides
agree on every name and shape).

* scalar: five VALID ConvBlocks (conv + bias -> BatchNorm -> ReLU), block 1
  stride 2 with a dilation, then per stem a 1x1 conv to one channel -> ReLU
  -> flatten (NCHW order) -> dense to one gain.
* resnet: a k3 pad-1 stem conv -> BN -> ReLU, BasicBlocks (conv3x3(stride)
  -> BN -> ReLU -> conv3x3 -> BN, plus a 1x1 strided projection -> BN where
  the shape changes, -> ReLU), then the same heads.

With ``calibrate=True`` every BatchNorm takes the batch's mean and biased
variance and writes them into the dict as its running statistics: the
benchmark sets its weights' BN statistics from the seed's own audio this
way, so that activations keep unit scale through the depth, as a trained
model's do.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import torch
import torch.nn.functional as F


def _bn(shapes, prefix: str, c: int) -> None:
    shapes[f"{prefix}.weight"] = ((c,), "bn_scale")
    shapes[f"{prefix}.bias"] = ((c,), "bn_shift")
    shapes[f"{prefix}.running_mean"] = ((c,), "bn_mean")
    shapes[f"{prefix}.running_var"] = ((c,), "bn_var")
    shapes[f"{prefix}.num_batches_tracked"] = ((), "count")


def _heads(shapes, cfg: Dict, c: int, flat: int) -> None:
    for i in range(1, cfg["num_stems"] + 1):
        shapes[f"head{i}.conv.weight"] = ((1, c, 1, 1), "weight")
        shapes[f"head{i}.conv.bias"] = ((1,), "bias")
        shapes[f"head{i}.fc.weight"] = ((1, flat), "weight")
        shapes[f"head{i}.fc.bias"] = ((1,), "bias")


def param_shapes(cfg: Dict):
    """``name -> (shape, kind)`` of every parameter and BN buffer."""
    from portbench.reference.counts import trunk_layers

    shapes: OrderedDict = OrderedDict()
    c_in = cfg["num_stems"]
    if cfg["family"] == "resnet":
        stem = cfg["stem_width"]
        shapes["stem_conv.weight"] = ((stem, c_in, 3, 3), "weight")
        _bn(shapes, "stem_bn", stem)
        c_in = stem
        for si, (n, width, stride) in enumerate(cfg["stages"], start=1):
            for b in range(1, n + 1):
                p = f"layer{si}_block{b}"
                shapes[f"{p}.conv1.weight"] = ((width, c_in, 3, 3), "weight")
                _bn(shapes, f"{p}.bn1", width)
                shapes[f"{p}.conv2.weight"] = ((width, width, 3, 3), "weight")
                _bn(shapes, f"{p}.bn2", width)
                if (stride if b == 1 else 1) != 1 or c_in != width:
                    shapes[f"{p}.shortcut_conv.weight"] = ((width, c_in, 1, 1), "weight")
                    _bn(shapes, f"{p}.shortcut_bn", width)
                c_in = width
    else:
        for i, (c_out, k, _) in enumerate(cfg["trunk"], start=1):
            shapes[f"conv_b{i}.conv.weight"] = ((c_out, c_in, k, k), "weight")
            shapes[f"conv_b{i}.conv.bias"] = ((c_out,), "bias")
            _bn(shapes, f"conv_b{i}.bn", c_out)
            c_in = c_out
    _, (c, h, w) = trunk_layers(cfg)
    _heads(shapes, cfg, c, h * w)
    return shapes


class _Net:
    """Applies the layers of one weight dict; BN eval or calibrating."""

    def __init__(self, w: Dict[str, torch.Tensor], eps: float, calibrate: bool):
        self.w, self.eps, self.calibrate = w, eps, calibrate

    def bn(self, x: torch.Tensor, p: str) -> torch.Tensor:
        w = self.w
        if self.calibrate:
            with torch.no_grad():
                w[f"{p}.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
                w[f"{p}.running_var"].copy_(x.var(dim=(0, 2, 3), unbiased=False))
        mean, var = w[f"{p}.running_mean"], w[f"{p}.running_var"]
        scale = w[f"{p}.weight"] * torch.rsqrt(var + self.eps)
        return (x - mean[:, None, None]) * scale[:, None, None] + w[f"{p}.bias"][:, None, None]

    def heads(self, h: torch.Tensor, n: int) -> torch.Tensor:
        w = self.w
        out = []
        for i in range(1, n + 1):
            m = torch.relu(F.conv2d(h, w[f"head{i}.conv.weight"], w[f"head{i}.conv.bias"]))
            out.append(F.linear(m.reshape(m.shape[0], -1), w[f"head{i}.fc.weight"],
                                w[f"head{i}.fc.bias"]))
        return torch.cat(out, dim=-1)


def scalar_gains(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
                 calibrate: bool = False) -> torch.Tensor:
    net = _Net(w, cfg["bn_eps"], calibrate)
    h = x
    for i, (_, _, s) in enumerate(cfg["trunk"], start=1):
        d = cfg["block1_dilation"] if i == 1 else 1
        h = F.conv2d(h, w[f"conv_b{i}.conv.weight"], w[f"conv_b{i}.conv.bias"],
                     stride=s, dilation=d)
        h = torch.relu(net.bn(h, f"conv_b{i}.bn"))
    return net.heads(h, cfg["num_stems"])


def resnet_gains(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
                 calibrate: bool = False) -> torch.Tensor:
    net = _Net(w, cfg["bn_eps"], calibrate)
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


def gains(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
          calibrate: bool = False) -> torch.Tensor:
    """``x [N, stems, bins, frames]`` float32 features -> ``[N, stems]``
    model-scalar gains."""
    fn = resnet_gains if cfg["family"] == "resnet" else scalar_gains
    with torch.no_grad():
        return fn(w, x.contiguous(), cfg, calibrate)
