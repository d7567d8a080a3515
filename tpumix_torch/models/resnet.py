"""ResNet gain-prediction backbone (tpumix/models/resnet.py; reference
models/model_resnet.py:59-130).

CIFAR-style ResNet-18 variant: stem conv(4->16, k3, s1, pad 1), six stages of
BasicBlocks [2,2,2,2,2,2] with widths 16/32/64/96/128/256 and strides
1,2,2,2,2,2, then the same four scalar heads as the scalar models; flattened
head dim 231 = 33*7 at the pinned [1025, 216]-bin/frame input (5 s chunks at
hop 1024).  Module names are the flax ones (``stem_conv``, ``stem_bn``,
``layer{s}_block{b}``, ``head{i}``), so checkpoints convert by name.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from tpumix_torch.models.blocks import BasicBlock, ScalarHead, _resnet_bn
from tpumix_torch.ops.gain import spectral_mix

NUM_STEMS = 4


def resnet_output_hw(F: int, T: int, strides: Sequence[int]) -> Tuple[int, int]:
    """Spatial size after the stages: each k3 / pad 1 conv of stride s maps
    n to (n - 1) // s + 1."""
    for s in strides:
        F, T = (F - 1) // s + 1, (T - 1) // s + 1
    return F, T


class GainResNet(nn.Module):
    """``forward(x [B, S, F, T]) -> (masked [B, F, T], gains [B, S])``, the
    scalar models' contract; ``gains(x)`` is what ``SongMixer`` calls."""

    def __init__(self, in_shape: Tuple[int, int] = (1025, 216), num_stems: int = NUM_STEMS,
                 num_blocks: Sequence[int] = (2, 2, 2, 2, 2, 2),
                 widths: Sequence[int] = (16, 32, 64, 96, 128, 256),
                 strides: Sequence[int] = (1, 2, 2, 2, 2, 2),
                 compute_dtype: torch.dtype = torch.float32):
        """:param in_shape: ``(F, T)`` of the input spectrograms — it sizes
        the heads' dense layers."""
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_stems = num_stems
        self.stem_conv = nn.Conv2d(num_stems, 16, 3, padding=1, bias=False)
        self.stem_bn = _resnet_bn(16)
        self.blocks = []
        cin = 16
        for stage, (n, w, s) in enumerate(zip(num_blocks, widths, strides), start=1):
            for b in range(1, n + 1):
                name = f"layer{stage}_block{b}"
                setattr(self, name, BasicBlock(cin, w, s if b == 1 else 1))
                self.blocks.append(name)
                cin = w
        h, w = resnet_output_hw(*in_shape, strides)
        for i in range(1, num_stems + 1):
            setattr(self, f"head{i}", ScalarHead(cin, h * w))

    def gains(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, S, F, T]`` -> ``gains [B, S]`` float32 (no spectral mix);
        under a bfloat16 ``compute_dtype`` the heads run in bfloat16 too, as
        in the JAX package, and the gains are cast to float32 at the end."""
        h = x.to(torch.float32).contiguous(memory_format=torch.channels_last)
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            h = torch.relu(self.stem_bn(self.stem_conv(h)))
            for name in self.blocks:
                h = getattr(self, name)(h)
            gains = torch.cat([getattr(self, f"head{i}")(h)
                               for i in range(1, self.num_stems + 1)], dim=-1)
        return gains.to(torch.float32)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        gains = self.gains(x)
        return spectral_mix(x.to(torch.float32), gains), gains


def ResNet18(**kwargs) -> GainResNet:
    """Factory matching the reference ``ResNet18()`` (model_resnet.py:129-130)."""
    return GainResNet(**kwargs)
