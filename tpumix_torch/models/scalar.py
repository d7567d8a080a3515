"""Scalar gain-prediction CNNs (tpumix/models/scalar.py:41-141).

Input: stacked per-stem dB spectrograms ``x [B, 4, F, T]``; output
``(masked [B, F, T], gains [B, 4])`` with ``masked = sum_i gains_i * x_i`` (the
reference's dB-domain quirk, preserved).  Five ConvBlocks (4->16 k3 s2,
16->32 k5, 32->48 k5, 48->64 k7, 64->128 k9) and four scalar heads; the 2 s
models dilate block 1 by 2.  The L variants feed each head the per-stem mean
dB / 20 after the flatten (a tpumix extension).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tpumix_torch.models.blocks import ConvBlock2d, ScalarHead
from tpumix_torch.ops.gain import spectral_mix
from tpumix_torch.parallel.frames import FrameShard

NUM_STEMS = 4
# (features, kernel, dropout p) of blocks 2-5; block 1 is 16 k3 stride 2
_TRUNK = ((32, 5, 0.2), (48, 5, 0.2), (64, 7, 0.2), (128, 9, 0.3))


def trunk_output_hw(F: int, T: int, block1_dilation: int) -> Tuple[int, int]:
    """Spatial size after the five VALID blocks."""
    eff = 2 * block1_dilation + 1  # k3 dilated
    h, w = (F - eff) // 2 + 1, (T - eff) // 2 + 1
    for _, k, _ in _TRUNK:
        h, w = h - k + 1, w - k + 1
    return h, w


class _ScalarModelBase(nn.Module):
    block1_dilation = 1
    level_features = False

    def __init__(self, in_shape: Tuple[int, int] = (1025, 173), num_stems: int = NUM_STEMS,
                 bn_momentum: float = 0.10, use_dropout: bool = True, conv_impl: str = "xla",
                 compute_dtype: torch.dtype = torch.float32):
        """:param in_shape: ``(F, T)`` of the input spectrograms — it sizes
        the heads' dense layers (the reference's flattened head dims)."""
        super().__init__()
        self.compute_dtype = compute_dtype
        self.bn_momentum = bn_momentum  # read by the trainer's short-run warning

        def block(cin, f, k, s=1, d=1, p=0.2):
            return ConvBlock2d(cin, f, k, strides=s, dilation=d,
                               dropout_p=p if use_dropout else -1.0,
                               bn_momentum=bn_momentum, conv_impl=conv_impl)

        self.conv_b1 = block(num_stems, 16, 3, s=2, d=self.block1_dilation)
        cin = 16
        for i, (f, k, p) in enumerate(_TRUNK, start=2):
            setattr(self, f"conv_b{i}", block(cin, f, k, p=p))
            cin = f
        h, w = trunk_output_hw(*in_shape, self.block1_dilation)
        if h <= 0 or w <= 0:
            raise ValueError(f"input {in_shape} is too small for the five VALID blocks")
        flat = h * w + (num_stems if self.level_features else 0)
        for i in range(1, num_stems + 1):
            setattr(self, f"head{i}", ScalarHead(cin, flat))
        self.num_stems = num_stems

    def frame_shard(self, frames: int, axis, rows: int = 1) -> FrameShard:
        """The part of the frame axis of a ``frames``-frame input that the
        ``sp`` rank ``axis`` computes and owns (tpumix_torch/parallel/frames.py);
        ``rows`` is the number of ``dp`` ranks."""
        layers = [(3, 2, self.block1_dilation)] + [(k, 1, 1) for _, k, _ in _TRUNK]
        return FrameShard.build(frames, layers, axis, rows)

    def gains(self, x: torch.Tensor, shard: Optional[FrameShard] = None) -> torch.Tensor:
        """``x [B, S, F, T]`` -> ``gains [B, S]`` float32 (no spectral mix).

        Under a bfloat16 ``compute_dtype`` the trunk, the heads and the level
        features run in bfloat16, as in the JAX package (its heads take the
        model's dtype and the levels are cast to it); the gains are cast to
        float32 at the end.  Parameters and BN statistics stay float32.

        With ``shard`` (:meth:`frame_shard`), ``x`` holds this rank's feature
        frames ``shard.features``; BatchNorm takes its statistics over the
        owned frames, the heads sum their partial dots over the ``sp`` ranks
        and the level features are the means over all frames, so every rank
        returns the gains of the whole input."""
        if shard is not None:
            return self._sharded_gains(x, shard)
        h = x.to(torch.float32).contiguous(memory_format=torch.channels_last)
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            for i in range(1, 6):
                h = getattr(self, f"conv_b{i}")(h)
            levels = None
            if self.level_features:
                # per-stem mean dB, scaled to O(1), in the trunk's dtype
                levels = (x.to(torch.float32).mean(dim=(2, 3)) * (1.0 / 20.0)).to(h.dtype)
            gains = torch.cat(
                [getattr(self, f"head{i}")(h, extra=levels) for i in range(1, self.num_stems + 1)],
                dim=-1,
            )
        return gains.to(torch.float32)

    def _sharded_gains(self, x: torch.Tensor, shard: FrameShard) -> torch.Tensor:
        h = x.to(torch.float32).contiguous(memory_format=torch.channels_last)
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            for i in range(1, 6):
                h = getattr(self, f"conv_b{i}")(h, frames=(*shard.owned(i), shard.rows))
            levels = None
            if self.level_features:
                own, width = shard.owned(0)
                with torch.no_grad():
                    sums = shard.axis.all_reduce(x[..., :own].to(torch.float32).sum(dim=(2, 3)))
                levels = (sums / (x.shape[2] * width) * (1.0 / 20.0)).to(h.dtype)
            lo, hi, _, width = shard.ranges[-1]
            parts = torch.cat(
                [getattr(self, f"head{i}").partial(h, (lo, hi), width, extra=levels,
                                                   bias=shard.axis.index == 0)
                 for i in range(1, self.num_stems + 1)], dim=-1)
        return shard.axis.sum_identity_grad(parts.to(torch.float32))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """:param x: ``[B, num_stems, F, T]`` stacked dB spectrograms.
        :return: ``(masked [B, F, T], gains [B, num_stems])``."""
        gains = self.gains(x)
        return spectral_mix(x.to(torch.float32), gains), gains


class MixingModelScalar1s(_ScalarModelBase):
    """1-second-chunk scalar model (87-frame input, hop 512)."""


class MixingModelScalar1sL(_ScalarModelBase):
    """Scalar1s trunk + level-aware gain heads."""

    level_features = True


class MixingModelScalar2s(_ScalarModelBase):
    """2-second-chunk scalar model (173 frames); block 1 dilation 2."""

    block1_dilation = 2


class MixingModelScalar2sL(_ScalarModelBase):
    """Scalar2s trunk + level-aware gain heads (the flagship artifact)."""

    block1_dilation = 2
    level_features = True
