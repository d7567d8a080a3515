"""Seeded weights, made on the device in one draw and handed to both sides.

Every parameter and BN buffer named by ``reference.models.param_shapes``
comes from one ``torch.randn`` on the device: conv and dense weights at
lecun-normal scale (std ``1 / sqrt(fan_in)``), biases at ``bias_std``, BN
scales ``1 + bn_scale_std * n`` and shifts ``bn_shift_std * n``.  The BN
running statistics are then set by the reference from the seed's own audio
(``calibrate``), as a trained model's track its data.  The program receives
a copy (``load_state_dict(strict=True)``); the reference keeps the dict.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import frontend, models


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = models.param_shapes(cfg)
    wcfg = cfg["weights"]
    sizes = [math.prod(s) for s, _ in shapes.values()]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    for (name, (shape, kind)), part in zip(shapes.items(), torch.split(flat, sizes)):
        x = part.reshape(shape)
        if kind == "weight":
            x = x * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "bias":
            x = x * wcfg["bias_std"]
        elif kind == "bn_scale":
            x = 1.0 + wcfg["bn_scale_std"] * x
        elif kind == "bn_shift":
            x = wcfg["bn_shift_std"] * x
        elif kind == "bn_mean":
            x = torch.zeros_like(x)
        elif kind == "bn_var":
            x = torch.ones_like(x)
        elif kind == "count":
            x = torch.zeros((), dtype=torch.long, device=device)
        out[name] = x.contiguous()
    return out


def calibrate(weights: Dict[str, torch.Tensor], stems: torch.Tensor, cfg: Dict) -> None:
    """Set every BN's running statistics to those of the first
    ``weights.calibration_chunks`` chunks of ``stems [stems, S]`` (on the
    device), layer by layer, in full float32."""
    n = cfg["weights"]["calibration_chunks"]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        models.gains(weights, frontend.chunk_features(stems, 0, n, cfg), cfg, calibrate=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy the weights into the program's model, every name and shape
    matched (``strict``)."""
    model.load_state_dict({k: v.clone() for k, v in weights.items()}, strict=True)
