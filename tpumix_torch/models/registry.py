"""Model registry: preset name -> constructed ``nn.Module``
(tpumix/models/registry.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tpumix_torch.config import ModelConfig
from tpumix_torch.models.blocks import INFERENCE_ONLY
from tpumix_torch.models.dmc import DifferentiableMixingConsole, init_dmc_weights
from tpumix_torch.models.resnet import GainResNet
from tpumix_torch.models.scalar import (
    MixingModelScalar1s,
    MixingModelScalar1sL,
    MixingModelScalar2s,
    MixingModelScalar2sL,
)

_SCALAR = {
    "scalar1s": MixingModelScalar1s,
    "scalar1sL": MixingModelScalar1sL,
    "scalar2s": MixingModelScalar2s,
    "scalar2sL": MixingModelScalar2sL,
}

# flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax-style init from an explicit generator: lecun-normal conv and dense
    kernels, zero biases, BN at identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
    return model


def build_model(cfg: ModelConfig, in_shape: Optional[Tuple[int, int]] = None,
                generator: Optional[torch.Generator] = None,
                for_training: bool = False) -> nn.Module:
    """Construct the preset's model on the CPU with random weights drawn from
    ``generator`` (a generator seeded 0 when None), in eval mode, or in
    training mode (dropout on, batch statistics) when ``for_training``.  In
    training mode the blocks of ``conv_impl="pallas"`` and ``"auto"`` run
    ``F.conv2d``: the fused kernel is inference only;
    ``"khgemm_int8"`` is refused for training (``ValueError``), as in the JAX
    package.

    ``in_shape = (F, T)`` defaults to the preset's full spectrogram (1025
    bins x the pinned frame count); it sizes the heads' dense layers.
    ``conv_impl="auto"`` is decided by each block at forward time
    (blocks.py ``takes_fused_kernel``), since the model is built here on the
    CPU and moved later: the scalar trunk's blocks 2-5 run the fused kernel
    K2 in eval mode on the card, where it is float32-faithful and about 3x
    faster than cuDNN; every other block, and every block on the CPU or in
    training, runs ``F.conv2d``.  ``resnet18`` is ``GainResNet``,
    whose convolutions are ``F.conv2d`` whatever ``conv_impl`` says (as in
    the JAX package) and whose BatchNorm keeps torch's default momentum.
    ``dmc_vggish`` is ``DifferentiableMixingConsole`` (any number of tracks,
    ``in_shape`` unused): its VGGish convolutions take K2 under ``"auto"``
    only where ``takes_fused_kernel`` admits their route."""
    if cfg.name not in _SCALAR and cfg.name not in ("resnet18", "dmc_vggish"):
        raise ValueError(f"unknown model {cfg.name!r}; "
                         f"have {sorted([*_SCALAR, 'resnet18', 'dmc_vggish'])}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if cfg.name == "dmc_vggish":
        model = DifferentiableMixingConsole(conv_impl=cfg.conv_impl)
        return init_dmc_weights(model, generator).train(for_training)
    if in_shape is None:
        in_shape = (cfg.frontend().num_bins, cfg.num_frames)
    if cfg.conv_impl == "khgemm_int8" and for_training:
        raise ValueError(INFERENCE_ONLY)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if cfg.name == "resnet18":
        model = GainResNet(in_shape=in_shape, num_stems=cfg.num_stems, compute_dtype=dtype)
    else:
        model = _SCALAR[cfg.name](
            in_shape=in_shape, num_stems=cfg.num_stems, bn_momentum=cfg.bn_momentum,
            use_dropout=cfg.use_dropout, conv_impl=cfg.conv_impl, compute_dtype=dtype,
        )
    return init_weights(model, generator).train(for_training)


def example_feature_shape(cfg: ModelConfig, batch: int = 1):
    fe = cfg.frontend()
    return (batch, cfg.num_stems, fe.num_bins, cfg.num_frames)
