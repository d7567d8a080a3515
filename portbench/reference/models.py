"""Plain forward passes of the gain models, from a weight dict, in float32
with ``torch.nn.functional`` only.  Each family's layers are in
``families/<family>.py``; ``param_shapes`` and ``gains`` go through the
family that the configuration names.  What the families share is here: the
BatchNorm, evaluating or calibrating, and the scalar heads.

The parameter names follow the published flax/torch module names, which
the port's modules also use, so the benchmark's seeded weights load into
the program by name (``load_state_dict(strict=True)`` checks that both sides
agree on every name and shape).

With ``calibrate=True`` every BatchNorm takes the batch's mean and biased
variance and writes them into the dict as its running statistics: the
benchmark sets its weights' BN statistics from the seed's own audio this
way, so that activations keep unit scale through the depth, as a trained
model's do.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference import families


def bn_shapes(shapes, prefix: str, c: int) -> None:
    shapes[f"{prefix}.weight"] = ((c,), "bn_scale")
    shapes[f"{prefix}.bias"] = ((c,), "bn_shift")
    shapes[f"{prefix}.running_mean"] = ((c,), "bn_mean")
    shapes[f"{prefix}.running_var"] = ((c,), "bn_var")
    shapes[f"{prefix}.num_batches_tracked"] = ((), "count")


def head_shapes(shapes, cfg: Dict, c: int, flat: int) -> None:
    """Per stem a 1x1 conv to one channel -> ReLU -> flatten (NCHW order)
    -> dense to one gain."""
    for i in range(1, cfg["num_stems"] + 1):
        shapes[f"head{i}.conv.weight"] = ((1, c, 1, 1), "weight")
        shapes[f"head{i}.conv.bias"] = ((1,), "bias")
        shapes[f"head{i}.fc.weight"] = ((1, flat), "weight")
        shapes[f"head{i}.fc.bias"] = ((1,), "bias")


class Net:
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


def param_shapes(cfg: Dict):
    """``name -> (shape, kind)`` of every parameter and BN buffer."""
    return families.of(cfg).param_shapes(cfg)


def gains(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
          calibrate: bool = False) -> torch.Tensor:
    """The family's features of ``N`` chunks -> its ``N`` outputs
    (``[N, stems]`` model-scalar gains for the scalar heads)."""
    fn = families.of(cfg).forward
    with torch.no_grad():
        return fn(w, x.contiguous(), cfg, calibrate)
