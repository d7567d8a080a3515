"""Kernel K2: fused VALID conv + folded BatchNorm + ReLU.

Replaces the four Pallas entry points of tpumix/ops/conv_block_pallas.py
(``conv_block_fused_v2`` :480, ``conv_block_fused_khpack_v2`` :496,
``conv_block_fused`` :168, ``conv_block_fused_khpack`` :558), which compute one
function and differ only in Mosaic tiling tactics:

    y = relu(conv_valid(x, w) * scale + shift)

x NHWC float32, w HWIO float32, stride 1, dilation 1; ``scale``/``shift`` are
the inference-time BN fold (:func:`fold_batchnorm`).  ``conv_block_fused``
launches the CUDA implicit-GEMM kernel (tpumix_torch/csrc/conv_block.cu) for
CUDA tensors and runs ``conv_block_fused_plain`` for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


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


def conv_block_fused(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """Fused block ``[N, H, W, Cin]`` x ``[kh, kw, Cin, Cout]`` -> ``[N, Ho, Wo,
    Cout]`` (contiguous NHWC).  ``x`` may be a contiguous NHWC tensor or the
    NHWC view (``permute(0, 2, 3, 1)``) of a ``channels_last`` NCHW tensor.

    CUDA tensors: one launch of the hand-written kernel (``launches`` counts
    them); CPU tensors: :func:`conv_block_fused_plain`."""
    if x.device.type == "cpu":
        return conv_block_fused_plain(x, w, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"conv_block_fused takes a CPU or CUDA tensor, got {x.device}")
    tensors = {"x": x, "w": w, "scale": scale, "shift": shift}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"conv_block_fused kernel takes float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"conv_block_fused kernel takes contiguous {name} (NHWC / HWIO)")
        if t.data_ptr() % 16:
            raise ValueError(f"conv_block_fused kernel needs 16-byte aligned {name}")
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
    from tpumix_torch.ops import _build

    out = torch.empty((N, Ho, Wo, Cout), dtype=torch.float32, device=x.device)
    lib = _build.load("conv_block")
    err = lib.conv_block_launch(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
        N, H, W, Cin, kh, kw, Cout, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv_block kernel launch failed: cudaError_t {err}")
    conv_block_fused.launches += 1
    return out


conv_block_fused.launches = 0
