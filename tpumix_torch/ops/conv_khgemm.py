"""kh-unrolled GEMM convolution (tpumix/ops/conv_khgemm.py).

A VALID convolution, stride 1 and dilation 1, restructured so that one matrix
product covers every kernel row at once:

    partial[n, h, wo, kh*o] = window_cols[n, h, wo, kw*ci] @ W2[kw*ci, kh*o]
    out[n, ho, wo, o]       = sum_i partial[n, ho + i, wo, i, o]

The JAX package runs it as an XLA-level formulation (``jnp.matmul`` with
float32 accumulation), not a Pallas kernel, so the port is plain PyTorch:
``torch.matmul`` in float32 and the shifted adds in float32, whatever the
compute dtype.  Inputs in bfloat16 are widened to float32 for the product
(a product of two bfloat16 values is exact in float32), so no kh partial is
rounded before the adds; the result is cast back to the input's dtype.  The
product runs with autocast off: autocast would run it in bfloat16.  On the
card it runs in full float32 only where TF32 is off
(``utils/device.py::disable_tf32``).

Layouts are the JAX package's: ``x`` NHWC, ``w`` HWIO.  ``ConvBlock2d``
(tpumix_torch/models/blocks.py) hands its ``channels_last`` NCHW tensor over
as the NHWC view.

Three lowerings share the layout:
* :func:`conv2d_valid_khgemm`: the JAX package's hand-derived dense VJP;
* :func:`conv2d_valid_khgemm_hybrid`: the khgemm forward with the backward of
  ``F.conv2d``;
* ``conv2d_valid_khgemm_int8`` (tpumix_torch/ops/conv_int8.py): dynamic
  W8A8, inference only.

:func:`conv2d` dispatches as the JAX package does: stride 1 and dilation 1 go
to a khgemm lowering, block 1's stride 2 and ``scalar2s``'s dilation 2 to
``F.conv2d``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tpumix_torch.ops.conv_int8 import conv2d_valid_khgemm_int8


def _windows(x: torch.Tensor, kw: int, Wo: int) -> torch.Tensor:
    """Width windows ``[N, H, Wo, kw*Cin]`` of ``x [N, H, W, Cin]``."""
    return torch.cat([x[:, :, j: j + Wo, :] for j in range(kw)], dim=-1)


def khgemm_impl(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID convolution of ``x [N, H, W, Cin]`` with ``w [kh, kw, Cin, Cout]``
    as one float32 product and kh shifted float32 adds; ``[N, Ho, Wo, Cout]``
    in ``x``'s dtype."""
    N, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    Ho, Wo = H - kh + 1, W - kw + 1
    with torch.autocast(x.device.type, enabled=False):
        cols = _windows(x.float(), kw, Wo)
        w2 = w.float().permute(1, 2, 0, 3).reshape(kw * Cin, kh * Cout)
        part = torch.matmul(cols, w2).view(N, H, Wo, kh, Cout)
        del cols
        out = part[:, 0:Ho, :, 0]
        for i in range(1, kh):
            out = out + part[:, i: i + Ho, :, i]
    return out.to(x.dtype)


def _conv_valid(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
                dilation=(1, 1)) -> torch.Tensor:
    """``F.conv2d`` on NHWC / HWIO, VALID: the NCHW view of ``x`` keeps its
    memory (``channels_last``), and the result comes back as an NHWC view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=strides,
                 dilation=dilation)
    return y.permute(0, 2, 3, 1)


class _KhGemm(torch.autograd.Function):
    """khgemm forward with the JAX package's hand-derived dense VJP
    (tpumix/ops/conv_khgemm.py:82-114)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return khgemm_impl(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        N, H, W, Cin = x.shape
        kh, kw, _, Cout = w.shape
        Ho, Wo = H - kh + 1, W - kw + 1
        # dx: VALID khgemm conv of the zero-padded cotangent with the kernel
        # turned 180 degrees and its channels swapped (the dense transpose conv)
        gp = F.pad(g, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
        dx = khgemm_impl(gp, w.flip(0, 1).permute(0, 1, 3, 2))
        # dw[i, j, ci, co] = sum_{n,h,w} x[n, h+i, w+j, ci] * g[n, h, w, co]:
        # one product per kernel row over the flattened (n, h, w)
        with torch.autocast(x.device.type, enabled=False):
            g2 = g.float().reshape(-1, Cout)
            dws = [torch.matmul(_windows(x[:, i: i + Ho].float(), kw, Wo)
                                .reshape(-1, kw * Cin).t(), g2) for i in range(kh)]
        dw = torch.stack(dws).reshape(kh, kw, Cin, Cout)
        return dx.to(x.dtype), dw.to(w.dtype)


class _KhGemmHybrid(torch.autograd.Function):
    """khgemm forward with the backward of ``F.conv2d``: the two forwards
    compute one function up to float32 reassociation."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return khgemm_impl(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xd, wd = x.detach().requires_grad_(), w.detach().requires_grad_()
            dx, dw = torch.autograd.grad(_conv_valid(xd, wd), (xd, wd), g)
        return dx, dw


def conv2d_valid_khgemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID convolution, stride 1, dilation 1: ``x [N, H, W, Cin]`` (NHWC),
    ``w [kh, kw, Cin, Cout]`` (HWIO) -> ``[N, H-kh+1, W-kw+1, Cout]``, with the
    hand-derived dense VJP: ``dx`` a khgemm conv of the padded cotangent with
    the flipped, channel-swapped kernel; ``dw`` one GEMM per kernel row."""
    return _KhGemm.apply(x, w)


def conv2d_valid_khgemm_hybrid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The khgemm forward with ``F.conv2d``'s backward
    (``conv_impl="khgemm_hybrid"``)."""
    return _KhGemmHybrid.apply(x, w)


def conv2d(x: torch.Tensor, w: torch.Tensor, strides: Tuple[int, int] = (1, 1),
           dilation: Tuple[int, int] = (1, 1), vjp: str = "khgemm") -> torch.Tensor:
    """VALID conv dispatch on NHWC / HWIO: a khgemm lowering for stride 1 and
    dilation 1 (``vjp``: ``"khgemm"`` the hand VJP, ``"xla"`` the hybrid,
    ``"int8"`` the W8A8 inference lowering), ``F.conv2d`` for the rest."""
    if tuple(strides) == (1, 1) and tuple(dilation) == (1, 1):
        if vjp == "int8":
            return conv2d_valid_khgemm_int8(x, w)
        if vjp == "xla":
            return conv2d_valid_khgemm_hybrid(x, w)
        return conv2d_valid_khgemm(x, w)
    return _conv_valid(x, w, strides, dilation)
