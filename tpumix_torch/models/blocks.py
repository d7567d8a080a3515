"""Building blocks of the gain models (tpumix/models/blocks.py:136-361).

ConvBlock2d is Conv2d(VALID) -> BatchNorm(eps 1e-3, torch momentum 0.90 ==
flax retained fraction 0.10) -> ReLU -> Dropout (train only), reference
model_scalar_1s.py:151-190.  The trunk runs in ``torch.channels_last``, so the
NHWC view the fused kernel and the khgemm lowerings take is free.  In
training mode the fused kernel's blocks (``conv_impl="pallas"`` and
``"auto"``) are ``F.conv2d`` + BN + ReLU (+ dropout): the kernel is inference
only.
The ResNet family's ``BasicBlock`` and ``Bottleneck`` are ``F.conv2d`` + BN
throughout, as in the JAX package (plain ``nn.Conv``, no Pallas kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpumix_torch.ops import conv_khgemm
from tpumix_torch.ops.conv_block import (
    PackedConvBlock,
    conv_block_fused_packed,
    fold_batchnorm,
    pack_conv_weights,
)

BN_EPS = 1e-3

#: every ``conv_impl`` a block takes
CONV_IMPLS = ("auto", "xla", "pallas", "khgemm", "khgemm_hybrid", "khgemm_int8")
# the khgemm lowerings, by the ``vjp`` of tpumix_torch/ops/conv_khgemm.py::conv2d
_KHGEMM_VJP = {"khgemm": "khgemm", "khgemm_hybrid": "xla", "khgemm_int8": "int8"}

INFERENCE_ONLY = (
    "conv_impl='khgemm_int8' is inference-only (round-to-nearest has no useful "
    "gradient); train with 'xla' or 'khgemm_hybrid' and switch at eval time: "
    "the parameters are the same")


#: ``(Cin, Cout)`` of the 3x3 SAME blocks (:class:`ConvReLU2d`) at which
#: K2's FP32 SIMT route was timed faster than cuDNN's float32 convolution on
#: the card at a 64-chunk segment of 16 tracks (``chip_smoke.py --phases
#: dmc``; PERF.md, section 6): none.  VGGish's 256- and 512-channel blocks
#: ran it at 0.51-0.73x cuDNN's speed; its wgmma route (conv2) at 4.2x.
K2_SIMT_FASTER: frozenset = frozenset()


def _pair(k: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


def takes_fused_kernel(conv_impl: str, device_type: str, training: bool, records_grad: bool,
                       stride: Tuple[int, int], dilation: Tuple[int, int],
                       x_dtype: torch.dtype, w_dtype: torch.dtype, cin: int, cout: int,
                       route: Optional[str] = None) -> bool:
    """Whether a :class:`ConvBlock2d` runs the fused conv+BN+ReLU kernel K2
    (tpumix_torch/ops/conv_block.py) for an input it sees.

    ``"pallas"`` takes it for every block the JAX package fuses: eval mode,
    stride 1, dilation 1, float32 (tpumix/models/blocks.py:166-173); on the
    CPU that is the kernel's float64 plain version.  ``"auto"`` takes it on
    the card alone, and only where it computes what ``F.conv2d`` + BN + ReLU
    would: no gradient is recorded (the kernel has no backward), the channel
    counts are the launcher's (divisible by 4).  There it is float32-faithful
    (3xTF32) and runs the scalar trunk's blocks 2-5 about 3x faster than
    cuDNN's float32 convolutions (PERF.md, section 6).  Everywhere else
    ``"auto"`` is ``"xla"``: the CPU, training, block 1 (stride 2, dilation
    2), bfloat16.

    ``route`` is the launcher's route for the block's shape on the card
    (``ops.conv_block.conv_block_route``) where the block holds the kernel
    to it, as :class:`ConvReLU2d` does: neither takes a shape the launcher
    refuses (``"none"``: VGGish's conv1 reads one channel), and ``"auto"``
    takes the ``wgmma`` route, and the FP32 SIMT route only for the shapes
    in :data:`K2_SIMT_FASTER`.  ``None`` (``ConvBlock2d``) asks no route:
    every scalar trunk block is on the ``wgmma`` route."""
    if conv_impl not in ("pallas", "auto"):
        return False
    eligible = (not training and stride == (1, 1) and dilation == (1, 1)
                and x_dtype == torch.float32 and w_dtype == torch.float32
                and route != "none")
    if conv_impl == "pallas" or not eligible:
        return eligible
    return (device_type == "cuda" and not records_grad and cin % 4 == 0 and cout % 4 == 0
            and (route in (None, "wgmma") or (cin, cout) in K2_SIMT_FASTER))


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
    it folds the unbiased variance.

    ``frames = (owned, width, rows)`` (a frame-sharded trunk,
    tpumix_torch/parallel/frames.py): ``x`` holds this rank's frames of a
    layer ``width`` frames wide over ``rows`` data-parallel ranks, and the
    statistics are taken over its first ``owned`` frames, which the ranks'
    own frames partition."""

    global_axis = None

    def forward(self, x: torch.Tensor, frames: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if frames is not None or (self.global_axis is not None and self.global_axis.size > 1):
            return self._global_forward(x, frames)
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

    def _global_forward(self, x: torch.Tensor, frames=None) -> torch.Tensor:
        """Training-mode batch norm over the ranks' shards together, in
        float32: the global mean, then the biased variance about it (two
        passes, each a differentiable all-reduce of per-channel sums over the
        owned elements, so the backward sums the gradients of every rank's
        loss)."""
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        axis = self.global_axis
        xf = x.float()
        if frames is None:
            n = (x.numel() // x.shape[1]) * axis.size
            own = x.shape[-1]
        else:
            own, width, rows = frames
            n = x.shape[0] * rows * x.shape[2] * width
        mean = axis.sum_with_grad(xf[..., :own].sum(dim=(0, 2, 3))) / n
        xc = xf - mean[:, None, None]
        var = axis.sum_with_grad(torch.square(xc[..., :own]).sum(dim=(0, 2, 3))) / n
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

    ``conv_impl="pallas"`` and ``"auto"`` run the blocks that
    :func:`takes_fused_kernel` admits through the fused conv+BN+ReLU kernel
    with BN folded; their other blocks, training mode included, are
    ``F.conv2d`` + BN + ReLU (the JAX package trains them through khgemm's
    hand VJP, which computes the same function).  ``"auto"`` admits eval-mode
    float32 blocks on the card only, so on the CPU it is ``"xla"``.  The
    folded and packed operands of the kernel are made once and kept until a
    parameter or a BN buffer changes.

    ``"khgemm"``, ``"khgemm_hybrid"`` and ``"khgemm_int8"`` lower the
    convolution through tpumix_torch/ops/conv_khgemm.py (stride 1 and
    dilation 1; the others take ``F.conv2d``), then add the bias in the
    compute dtype (tpumix/models/blocks.py:63-77); ``"khgemm_int8"`` refuses
    training mode.  Every ``conv_impl`` holds the same ``nn.Conv2d``
    parameters, so state dicts interchange."""

    def __init__(self, in_features: int, features: int, kernel_size, strides: int = 1,
                 dilation: int = 1, dropout_p: float = -1.0, bn_momentum: float = 0.10,
                 conv_impl: str = "xla"):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {conv_impl!r}; have {CONV_IMPLS}")
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
        device = x.device.type
        # the dtype the block computes in: autocast's where it is on
        dtype = torch.get_autocast_dtype(device) if torch.is_autocast_enabled(device) else x.dtype
        w = self.conv.weight
        return takes_fused_kernel(
            self.conv_impl, device, self.training,
            torch.is_grad_enabled() and (x.requires_grad or w.requires_grad),
            self.conv.stride, self.conv.dilation, dtype, w.dtype,
            self.conv.in_channels, self.conv.out_channels)

    def _khgemm(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution through a khgemm lowering, in the compute dtype
        (autocast's where it is on), the bias added after it."""
        if self.conv_impl == "khgemm_int8" and self.training:
            raise ValueError(INFERENCE_ONLY)
        dtype = (torch.get_autocast_dtype(x.device.type)
                 if torch.is_autocast_enabled(x.device.type) else x.dtype)
        nhwc = x.to(dtype).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        w = self.conv.weight.to(dtype).permute(2, 3, 1, 0)  # OIHW -> HWIO
        y = conv_khgemm.conv2d(nhwc, w, self.conv.stride, self.conv.dilation,
                               vjp=_KHGEMM_VJP[self.conv_impl])
        return y.permute(0, 3, 1, 2) + self.conv.bias.to(dtype)[:, None, None]

    def forward(self, x: torch.Tensor, frames: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
        """``frames``: BatchNorm's owned frames of a frame-sharded trunk
        (:class:`BatchNorm2d`)."""
        if self._fused_eligible(x):
            nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            y = conv_block_fused_packed(nhwc, self._fused_operands())
            return y.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        y = self._khgemm(x) if self.conv_impl in _KHGEMM_VJP else self.conv(x)
        x = torch.relu(self.bn(y) if frames is None else self.bn(y, frames))
        if self.dropout is not None:
            x = self.dropout(x)
        return x


class ConvReLU2d(nn.Conv2d):
    """VGG's layer (tensorflow/models research/audioset/vggish
    ``vggish_slim``): a 3x3 convolution of stride 1 with SAME padding, bias,
    then ReLU.  That is K2's function on the 1-padded input with scale 1 and
    shift = bias, so ``conv_impl`` takes ``"auto"``, ``"pallas"`` or
    ``"xla"`` as :class:`ConvBlock2d` does, and ``"auto"`` holds the kernel to
    the routes :func:`takes_fused_kernel` admits (the launcher's route is
    asked once per input shape).  The parameters are the ``nn.Conv2d``'s."""

    def __init__(self, in_features: int, features: int, conv_impl: str = "xla"):
        if conv_impl not in ("auto", "pallas", "xla"):
            raise ValueError(f"ConvReLU2d takes conv_impl 'auto', 'pallas' or 'xla', "
                             f"not {conv_impl!r}")
        super().__init__(in_features, features, 3, padding=1)
        self.conv_impl = conv_impl
        self._packed: Optional[PackedConvBlock] = None
        self._packed_key: Optional[tuple] = None
        self._routes: dict = {}

    def _fused_operands(self) -> PackedConvBlock:
        """Weights packed for the kernel with scale 1 and shift = bias,
        made anew when either changes (as ``ConvBlock2d._fused_operands``)."""
        key = tuple((t._version, t.data_ptr(), t.device) for t in (self.weight, self.bias))
        if key != self._packed_key:
            with torch.no_grad():
                self._packed = pack_conv_weights(self.weight.permute(2, 3, 1, 0),
                                                 torch.ones_like(self.bias), self.bias)
            self._packed_key = key
        return self._packed

    def _route(self, padded_shape: Tuple[int, int, int, int]) -> str:
        if padded_shape not in self._routes:
            from tpumix_torch.ops.conv_block import conv_block_route

            self._routes[padded_shape] = conv_block_route(
                padded_shape, (3, 3, self.in_channels, self.out_channels))
        return self._routes[padded_shape]

    def _fused_eligible(self, x: torch.Tensor) -> bool:
        device = x.device.type
        route = None
        if self.conv_impl != "xla" and device == "cuda":
            n, _, h, w = x.shape
            route = self._route((n, h + 2, w + 2, self.in_channels))
        return takes_fused_kernel(
            self.conv_impl, device, self.training,
            torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad),
            self.stride, self.dilation, x.dtype, self.weight.dtype, self.in_channels,
            self.out_channels, route=route)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fused_eligible(x):
            nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            y = conv_block_fused_packed(F.pad(nhwc, (0, 0, 1, 1, 1, 1)), self._fused_operands())
            return y.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        return torch.relu(super().forward(x))


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

    def partial(self, x: torch.Tensor, columns: Tuple[int, int], width: int,
                extra: Optional[torch.Tensor] = None, bias: bool = True) -> torch.Tensor:
        """This rank's part ``[B, 1]`` of the head's output when ``x`` holds
        the columns ``[c0, c1)`` of a ``width``-wide input: the dense layer's
        weights of those columns (NCHW flatten), plus, where ``bias``, the
        ``extra`` features' terms and the bias.  The parts sum to
        :meth:`forward` of the whole input."""
        h = torch.relu(self.conv(x))[:, 0]  # [B, H, c1 - c0]
        H = h.shape[1]
        w = self.fc.weight[0]
        cols = w[: H * width].view(H, width)[:, columns[0]: columns[1]]
        out = torch.einsum("bhw,hw->b", h, cols.to(h.dtype))[:, None]
        if bias:
            if extra is not None:
                out = out + extra.to(h.dtype) @ w[H * width:].to(h.dtype)[:, None]
            return out + self.fc.bias.to(h.dtype)
        # a zero term, so every rank has the bias gradient that the gradient
        # all-reduce expects
        return out + 0.0 * self.fc.bias.to(h.dtype)


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
