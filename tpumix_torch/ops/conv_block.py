"""Kernel K2: fused VALID conv + folded BatchNorm + ReLU.

Replaces the four Pallas entry points of tpumix/ops/conv_block_pallas.py
(``conv_block_fused_v2`` :480, ``conv_block_fused_khpack_v2`` :496,
``conv_block_fused`` :168, ``conv_block_fused_khpack`` :558), which compute one
function and differ only in Mosaic tiling tactics:

    y = relu(conv_valid(x, w) * scale + shift)

x NHWC float32, w HWIO float32, stride 1, dilation 1; ``scale``/``shift`` are
the inference-time BN fold (:func:`fold_batchnorm`).

On a CUDA tensor ``conv_block_fused`` launches the hand-written kernel
(tpumix_torch/csrc/conv_block.cu).  For the trunk's shapes (``Cin % 8 == 0``,
``Cout`` in 32, 48, 64, 128) that is an implicit GEMM on the tensor cores:
``wgmma`` in TF32 with float32 accumulators, every product made of three TF32
products of the operands' ``hi``/``lo`` halves (3xTF32), so the result keeps
float32 grade.  TF32 ``wgmma`` reads both operands K-major, so the weights are
packed once (:func:`pack_conv_weights`) and ``ConvBlock2d`` keeps the packed
form; :func:`conv_block_fused_packed` is the entry that takes it.  Other
shapes run the FP32 SIMT kernel of the same source; the C launcher chooses by
shape (``conv_block_route``).  On a CPU tensor the wrapper runs
``conv_block_fused_plain``, the float64 reference the kernel is held to
(rtol 1e-4, atol 5e-5); ``conv_block_fused_tf32_emulated`` repeats the
kernel's arithmetic in torch ops, so the scheme itself is testable on any
host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

K_CHUNK = 32  # the kernel's weight chunk: each kernel row's K is padded to a multiple


def fold_batchnorm(conv_bias: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``relu(bn(conv(x) + bias)) == relu(conv(x) * s + t)`` with the
    returned ``(s, t)`` (conv_block_pallas.py:644-656)."""
    s = gamma * torch.rsqrt(var + eps)
    t = (conv_bias - mean) * s + beta
    return s, t


def conv_block_fused_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                           shift: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` + scale/shift + ReLU on NHWC ``x`` and HWIO ``w``; returns
    NHWC float32.

    It computes in float64 and rounds once at the end, so that it is the
    accuracy reference the kernel is held to: a float32 sum over K = 5184
    terms (block 5) is off by ~1e-5 of the output scale in its worst cases,
    and two float32 versions compared with each other would show both
    errors."""
    d = torch.float64
    y = F.conv2d(x.permute(0, 3, 1, 2).to(d), w.permute(3, 2, 0, 1).to(d))
    y = torch.relu(y * scale.to(d).view(1, -1, 1, 1) + shift.to(d).view(1, -1, 1, 1))
    return y.permute(0, 2, 3, 1).to(torch.float32)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of a float32 tensor: ``hi`` is ``v`` rounded to TF32 (10
    mantissa bits) to nearest, ties away from zero, as ``cvt.rna.tf32.f32``
    does it, by integer arithmetic on the bit pattern; ``lo = v - hi``, exact
    in float32, at most ``2^-11 |v|``."""
    bits = v.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = torch.where(torch.isfinite(v), hi, v)
    return hi, v - hi


def tf32_truncate(v: torch.Tensor) -> torch.Tensor:
    """What a tensor core reads of a float32 register: the upper 19 bits."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class PackedConvBlock:
    """The weights of one block as the kernel reads them.

    ``w``: HWIO float32, contiguous (the SIMT route's operand).  ``hilo``:
    ``[2, Cout, Kp]`` float32, the same weights K-major, split into their TF32
    ``hi`` and ``lo`` parts; k runs over (kernel row, kernel column, input
    channel) and every kernel row's ``kw * Cin`` values are zero-padded to a
    multiple of ``K_CHUNK``.  ``scale``, ``shift``: ``[Cout]``."""

    w: torch.Tensor
    hilo: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor


def pack_conv_weights(w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> PackedConvBlock:
    """Pack HWIO float32 ``w`` (and the folded ``scale``, ``shift``) for
    :func:`conv_block_fused_packed`.  Runs on the device ``w`` is on."""
    if w.dim() != 4 or w.dtype != torch.float32:
        raise ValueError(f"w must be float32 [kh, kw, Cin, Cout]; got {w.dtype} {tuple(w.shape)}")
    kh, kw, cin, cout = w.shape
    row_k = kw * cin
    padded = -(-row_k // K_CHUNK) * K_CHUNK
    rows = w.detach().permute(3, 0, 1, 2).reshape(cout, kh, row_k)
    hilo = torch.zeros((2, cout, kh, padded), dtype=torch.float32, device=w.device)
    hilo[0, :, :, :row_k], hilo[1, :, :, :row_k] = tf32_split(rows)
    return PackedConvBlock(w.detach().contiguous(), hilo.reshape(2, cout, kh * padded),
                           scale.detach().contiguous(), shift.detach().contiguous())


def conv_block_fused_tf32_emulated(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                                   shift: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The wgmma kernel's arithmetic in torch ops, on any device: both
    operands split by :func:`tf32_split`, ``lo`` truncated as the tensor core
    reads it, the products ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` as float32
    matmuls (each product of two TF32 values is exact in float32), float32
    accumulation, then the float32 epilogue.  ``passes=1`` keeps ``a_hi*b_hi``
    alone: plain TF32, which misses the kernel's tolerance."""
    if passes not in (1, 3):
        raise ValueError("passes is 1 (plain TF32) or 3 (3xTF32)")
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    ho, wo = h - kh + 1, wd - kw + 1
    # im2col with k ordered (i, j, c), as the kernel walks it
    cols = F.unfold(x.permute(0, 3, 1, 2), (kh, kw))  # [n, cin*kh*kw, ho*wo], k = (c, i, j)
    a = cols.reshape(n, cin, kh, kw, ho * wo).permute(0, 4, 2, 3, 1).reshape(n * ho * wo, -1)
    b = w.reshape(-1, cout)
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    acc = a_hi @ b_hi
    if passes == 3:
        acc = (tf32_truncate(a_lo) @ b_hi + a_hi @ tf32_truncate(b_lo)) + acc
    y = torch.relu(torch.addcmul(shift, acc, scale))
    return y.reshape(n, ho, wo, cout)


def _check_cuda_operands(x: torch.Tensor, tensors: dict) -> None:
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"conv_block_fused kernel takes float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"conv_block_fused kernel takes contiguous {name} (NHWC / HWIO)")
        if t.data_ptr() % 16:
            raise ValueError(f"conv_block_fused kernel needs 16-byte aligned {name}")


def conv_block_route(x_shape, w_shape) -> str:
    """Which kernel the C launcher runs for NHWC ``x_shape`` and HWIO
    ``w_shape``: ``"wgmma"`` or ``"simt"`` (``"none"``: it takes neither).
    Asks the built library, so it needs nvcc."""
    from tpumix_torch.ops import _build

    n, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    code = _build.load("conv_block").conv_block_route(n, h, wd, cin, kh, kw, cout)
    return {1: "wgmma", 0: "simt"}.get(code, "none")


def _launch(entry: str, x: torch.Tensor, packed: PackedConvBlock) -> torch.Tensor:
    """Check the operands and call C entry ``entry`` of the library once."""
    w, scale, shift = packed.w, packed.scale, packed.shift
    if x.device.type != "cuda":
        raise ValueError(f"conv_block_fused takes a CPU or CUDA tensor, got {x.device}")
    _check_cuda_operands(x, {"x": x, "w": w, "packed weights": packed.hilo, "scale": scale,
                             "shift": shift})
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be [N, H, W, Cin] and w [kh, kw, Cin, Cout]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    N, H, W, Cin = x.shape
    kh, kw, wcin, Cout = w.shape
    if wcin != Cin:
        raise ValueError(f"w expects {wcin} input channels, x has {Cin}")
    if scale.shape != (Cout,) or shift.shape != (Cout,):
        raise ValueError(f"scale and shift must be [{Cout}]")
    if Cin % 4 or Cout % 4:
        raise ValueError(f"the kernel takes Cin and Cout divisible by 4; got {Cin}, {Cout}")
    Ho, Wo = H - kh + 1, W - kw + 1
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"kernel {kh}x{kw} larger than input {H}x{W}")
    padded = -(-kw * Cin // K_CHUNK) * K_CHUNK
    if packed.hilo.shape != (2, Cout, kh * padded):
        raise ValueError(f"packed weights are {tuple(packed.hilo.shape)}, not "
                         f"{(2, Cout, kh * padded)}: pack them with pack_conv_weights")
    from tpumix_torch.ops import _build

    out = torch.empty((N, Ho, Wo, Cout), dtype=torch.float32, device=x.device)
    lib = _build.load("conv_block")
    err = getattr(lib, entry)(
        x.data_ptr(), w.data_ptr(), packed.hilo.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), N, H, W, Cin, kh, kw, Cout,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv_block kernel launch failed: cudaError_t {err}")
    conv_block_fused.launches += 1
    return out


def conv_block_fused_packed(x: torch.Tensor, packed: PackedConvBlock) -> torch.Tensor:
    """:func:`conv_block_fused` with the weights already packed by
    :func:`pack_conv_weights`: what a module calls on every forward.

    CUDA tensors: one launch of the hand-written kernel (counted on
    ``conv_block_fused.launches``).  CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return conv_block_fused_plain(x, packed.w, packed.scale, packed.shift)
    return _launch("conv_block_launch", x, packed)


def conv_block_fused_undrained(x: torch.Tensor, packed: PackedConvBlock) -> torch.Tensor:
    """For measurement only, on no path of the port: the wgmma kernel with the
    tensor cores' accumulators left to run over all of K (they add by
    truncation; the kernel proper restarts them at every chunk).  CUDA
    tensors on the wgmma route only."""
    return _launch("conv_block_undrained_launch", x, packed)


def conv_block_fused(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """Fused block ``[N, H, W, Cin]`` x ``[kh, kw, Cin, Cout]`` -> ``[N, Ho, Wo,
    Cout]`` (contiguous NHWC).  ``x`` may be a contiguous NHWC tensor or the
    NHWC view (``permute(0, 2, 3, 1)``) of a ``channels_last`` NCHW tensor.

    CUDA tensors: packs the weights and launches the hand-written kernel once
    (``launches`` counts them); CPU tensors: :func:`conv_block_fused_plain`."""
    if x.device.type == "cpu":
        return conv_block_fused_plain(x, w, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block_fused takes a CPU or CUDA tensor, got {x.device}")
    _check_cuda_operands(x, {"w": w, "scale": scale, "shift": shift})
    return conv_block_fused_packed(x, pack_conv_weights(w, scale, shift))


conv_block_fused.launches = 0
