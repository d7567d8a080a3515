"""Building blocks of the gain models (tpumix/models/blocks.py:136-361).

ConvBlock2d is Conv2d(VALID) -> BatchNorm(eps 1e-3, torch momentum 0.90 ==
flax retained fraction 0.10) -> ReLU -> Dropout (train only), reference
model_scalar_1s.py:151-190.  The trunk runs in ``torch.channels_last``, so the
NHWC view the fused kernel takes is free.  In training mode every block is
``F.conv2d`` + BN + ReLU (+ dropout); the fused kernel is inference only.
The ResNet family's ``BasicBlock`` and ``Bottleneck`` are ``F.conv2d`` + BN
throughout, as in the JAX package (plain ``nn.Conv``, no Pallas kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpumix_torch.ops.conv_block import (
    PackedConvBlock,
    conv_block_fused_packed,
    fold_batchnorm,
    pack_conv_weights,
)

BN_EPS = 1e-3


def _pair(k: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows the JAX package.

    Both frameworks normalise a training batch with its biased variance, but
    flax folds that same *biased* variance into ``batch_stats/var`` while
    torch folds the *unbiased* one (x n/(n-1)) into ``running_var``.  The
    running statistics travel: an exported ``.npz`` is read by tpumix and its
    checkpoints are read here, so the port keeps flax's.  The difference is
    1/n of the variance: invisible at the full width (n = 48*511*85 after
    block 1), visible on small batches.

    With ``global_axis`` (a ``MeshAxis`` of more than one rank, set by
    :func:`use_global_batchnorm`) a training batch is normalised over the
    GLOBAL batch, the ranks' shards together, as the JAX step under GSPMD
    does (tpumix/train/state.py:16-19).  ``nn.SyncBatchNorm`` is not used:
    it folds the unbiased variance."""

    global_axis = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.global_axis is not None and self.global_axis.size > 1:
            return self._global_forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        # torch folds the unbiased variance into a copy (which autograd keeps
        # for the backward); the biased one is folded into the buffer from it
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
        return y

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training-mode batch norm over the ranks' shards together, in
        float32: the global mean, then the biased variance about it (two
        passes, each a differentiable all-reduce of per-channel sums, so the
        backward sums the gradients of every rank's loss)."""
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        axis = self.global_axis
        xf = x.float()
        n = (x.numel() // x.shape[1]) * axis.size
        mean = axis.sum_with_grad(xf.sum(dim=(0, 2, 3))) / n
        xc = xf - mean[:, None, None]
        var = axis.sum_with_grad(torch.square(xc).sum(dim=(0, 2, 3))) / n
        scale = torch.rsqrt(var + self.eps)
        if self.affine:
            scale = scale * self.weight
        y = xc * scale[:, None, None]
        if self.affine:
            y = y + self.bias[:, None, None]
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        return y.to(x.dtype)


def use_global_batchnorm(model: nn.Module, axis) -> None:
    """Normalise every :class:`BatchNorm2d` of ``model`` over the global batch
    of the mesh axis ``axis`` (a ``MeshAxis``; None: each rank's own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.global_axis = axis


class ConvBlock2d(nn.Module):
    """Conv2d(VALID) -> BatchNorm -> ReLU -> Dropout(train-only).

    ``conv_impl="pallas"`` runs eligible blocks (eval mode, stride 1,
    dilation 1, float32 — the conditions of tpumix/models/blocks.py:166-173)
    through the fused conv+BN+ReLU kernel with BN folded; every other case
    is ``F.conv2d`` + BN + ReLU.  The folded and packed operands of the kernel
    are made once and kept until a parameter or a BN buffer changes."""

    def __init__(self, in_features: int, features: int, kernel_size, strides: int = 1,
                 dilation: int = 1, dropout_p: float = -1.0, bn_momentum: float = 0.10,
                 conv_impl: str = "xla"):
        super().__init__()
        if conv_impl not in ("xla", "pallas"):
            raise NotImplementedError(
                f"conv_impl {conv_impl!r} is not ported; have 'xla', 'pallas' "
                "(khgemm and int8 lowerings are ROADMAP.md item 16)"
            )
        self.conv = nn.Conv2d(in_features, features, _pair(kernel_size), stride=strides,
                              dilation=dilation, padding=0)
        # flax momentum is the retained fraction of the running stats; torch's
        # is the new batch's share
        self.bn = BatchNorm2d(features, eps=BN_EPS, momentum=1.0 - bn_momentum)
        self.dropout = nn.Dropout(dropout_p) if dropout_p > 0 else None
        self.conv_impl = conv_impl
        self._packed: Optional[PackedConvBlock] = None
        self._packed_key: Optional[tuple] = None

    def _fused_operands(self) -> PackedConvBlock:
        """BN folded and weights packed for the kernel, cached on the version
        counters of everything they are made from: an in-place update (an
        optimizer step, ``load_state_dict``) or a move to another device makes
        them anew."""
        sources = (self.conv.weight, self.conv.bias, self.bn.weight, self.bn.bias,
                   self.bn.running_mean, self.bn.running_var)
        key = tuple((t._version, t.data_ptr(), t.device) for t in sources)
        if key != self._packed_key:
            with torch.no_grad():
                s, t = fold_batchnorm(self.conv.bias, self.bn.weight, self.bn.bias,
                                      self.bn.running_mean, self.bn.running_var, self.bn.eps)
                w = self.conv.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO
                self._packed = pack_conv_weights(w, s, t)
            self._packed_key = key
        return self._packed

    def _fused_eligible(self, x: torch.Tensor) -> bool:
        return (
            self.conv_impl == "pallas"
            and not self.training
            and self.conv.stride == (1, 1)
            and self.conv.dilation == (1, 1)
            and x.dtype == torch.float32
            and self.conv.weight.dtype == torch.float32
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fused_eligible(x):
            nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            y = conv_block_fused_packed(nhwc, self._fused_operands())
            return y.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        x = torch.relu(self.bn(self.conv(x)))
        if self.dropout is not None:
            x = self.dropout(x)
        return x


class ScalarHead(nn.Module):
    """Per-stem gain head: Conv 1x1 (C->1) -> ReLU -> flatten -> Linear(1).

    With one output channel, the NCHW flatten of ``[B, 1, H, W]`` and the
    NHWC flatten of the JAX model enumerate the same H*W order."""

    def __init__(self, in_features: int, flat_features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, 1, 1)
        self.fc = nn.Linear(flat_features, 1)

    def forward(self, x: torch.Tensor, extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = torch.relu(self.conv(x)).reshape(x.shape[0], -1)
        if extra is not None:
            h = torch.cat([h, extra.to(h.dtype)], dim=-1)
        return self.fc(h)  # [B, 1]


# ResNet blocks (tpumix/models/blocks.py:266-361): BatchNorm at torch's default
# momentum 0.1 (flax retained fraction 0.9) and eps 1e-5, not the scalar
# blocks' 0.90 and 1e-3
RESNET_BN_MOMENTUM = 0.1
RESNET_BN_EPS = 1e-5


def _resnet_bn(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=RESNET_BN_EPS, momentum=RESNET_BN_MOMENTUM)


class BasicBlock(nn.Module):
    """CIFAR-style residual block (reference model_resnet.py:6-28):
    conv3x3(stride) -> bn -> relu -> conv3x3 -> bn (+ 1x1 projection shortcut
    when the shape changes) -> relu.  Paddings are torch's own k3 ``padding=1``
    and k1 ``padding=0``, which the JAX package spells out as ((1, 1), (1, 1))
    and ((0, 0), (0, 0)) to get the same window alignment."""

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride=strides, padding=1, bias=False)
        self.bn1 = _resnet_bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = _resnet_bn(features)
        self.shortcut_conv = self.shortcut_bn = None
        if strides != 1 or in_features != features:
            self.shortcut_conv = nn.Conv2d(in_features, features, 1, stride=strides, bias=False)
            self.shortcut_bn = _resnet_bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        shortcut = x if self.shortcut_conv is None else self.shortcut_bn(self.shortcut_conv(x))
        return torch.relu(out + shortcut)


class Bottleneck(nn.Module):
    """Bottleneck residual block (reference model_resnet.py:31-56): 1x1 ->
    3x3(stride) -> 1x1 to ``expansion * features``.  Unused by ResNet18 and
    ported for parity."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 expansion: int = 4):
        super().__init__()
        wide = features * expansion
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn1 = _resnet_bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=strides, padding=1, bias=False)
        self.bn2 = _resnet_bn(features)
        self.conv3 = nn.Conv2d(features, wide, 1, bias=False)
        self.bn3 = _resnet_bn(wide)
        self.shortcut_conv = self.shortcut_bn = None
        if strides != 1 or in_features != wide:
            self.shortcut_conv = nn.Conv2d(in_features, wide, 1, stride=strides, bias=False)
            self.shortcut_bn = _resnet_bn(wide)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        shortcut = x if self.shortcut_conv is None else self.shortcut_bn(self.shortcut_conv(x))
        return torch.relu(out + shortcut)
