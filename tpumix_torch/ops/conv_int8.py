"""Dynamic-W8A8 khgemm convolution, inference only (tpumix/ops/conv_int8.py).

Scheme, on the khgemm layout (tpumix_torch/ops/conv_khgemm.py):

* weights ``[kh, kw, Cin, Cout] -> w2 [kw*Cin, kh, Cout]``, one symmetric
  scale per (kernel row, output channel): ``w_q = round(w2 / colscale)``;
* activations: one symmetric scale per receptive-field window, a kw-wide
  sliding max over the per-pixel channel max (no float32 window matrix is
  made: each width slice quantises straight into the int8 window matrix);
* kh s8 x s8 -> s32 products, one per kernel row (exact integer
  accumulation), each dequantised in float32 (``part * rowscale *
  colscale``) and summed in float32.

The JAX package runs the products as ``lax.dot_general(...,
preferred_element_type=int32)``; here they are ``torch._int_mm``, on the card
and on the CPU.  On CUDA it needs more than 16 rows and K = kw*Cin and N =
Cout multiples of 8 (the trunk's 80/32, 160/48, 336/64 and 576/128 are);
another shape raises, naming it.

The codes are decided by divisions.  CUDA turns a division by a Python
scalar into a product with its reciprocal, which can move a value across a
rounding tie, so every divisor here is a tensor (``/ 127`` by a 0-dim one on
the input's device).  ``torch.round`` rounds half to even, as ``jnp.round``.

Inference only: round-to-nearest has no useful gradient, so ``ConvBlock2d``
and ``build_model(for_training=True)`` refuse ``conv_impl="khgemm_int8"`` in
training.
"""

from __future__ import annotations

from typing import Tuple

import torch

# symmetric int8 range; scales are clamped so all-zero rows / columns stay
# finite (they quantise to exact zeros either way)
_QMAX = 127.0
_EPS = 1e-30


def _qmax(device) -> torch.Tensor:
    return torch.tensor(_QMAX, dtype=torch.float32, device=device)


def _window_row_scales(x: torch.Tensor, kw: int, Wo: int) -> torch.Tensor:
    """Per-window symmetric scales ``[N, H, Wo, 1]``:
    ``max_{j<kw, c} |x[n, h, wo+j, c]| / 127``, from the per-pixel channel
    max and a kw-wide sliding max."""
    m = x.abs().amax(dim=-1)  # [N, H, W]
    scale = m[:, :, 0:Wo]
    for j in range(1, kw):
        scale = torch.maximum(scale, m[:, :, j: j + Wo])
    return torch.clamp(scale / _qmax(x.device), min=_EPS)[..., None]


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(kernel row, output channel) int8 quantisation of ``w [kh, kw, Cin,
    Cout]`` (HWIO): ``(w_q [kw*Cin, kh, Cout] int8, colscale [kh, Cout])``."""
    kh, kw, cin, cout = w.shape
    w2 = w.float().permute(1, 2, 0, 3).reshape(kw * cin, kh, cout)
    colscale = torch.clamp(w2.abs().amax(dim=0) / _qmax(w.device), min=_EPS)
    w_q = torch.clamp(torch.round(w2 / colscale), -_QMAX, _QMAX).to(torch.int8)
    return w_q, colscale


def quantize_windows(x: torch.Tensor, kw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 window matrix of ``x [N, H, W, Cin]`` and its scales:
    ``(cols_q [N, H, Wo, kw*Cin] int8, rowscale [N, H, Wo, 1])``.  The scale
    is indexed by the OUTPUT window position, so this equals quantising a
    materialised float32 window matrix row by row."""
    Wo = x.shape[2] - kw + 1
    xf = x.float()
    rowscale = _window_row_scales(xf, kw, Wo)
    cols_q = torch.cat(
        [torch.clamp(torch.round(xf[:, :, j: j + Wo, :] / rowscale), -_QMAX, _QMAX)
         .to(torch.int8) for j in range(kw)], dim=-1)
    return cols_q, rowscale


def _s8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` in int8 with exact int32 accumulation."""
    if a.is_cuda and (a.shape[0] <= 16 or a.shape[1] % 8 or b.shape[1] % 8):
        raise ValueError(
            f"torch._int_mm on CUDA needs M > 16 and K, N multiples of 8; got M, K, N = "
            f"{a.shape[0]}, {a.shape[1]}, {b.shape[1]}")
    return torch._int_mm(a.contiguous(), b.contiguous())


def conv2d_valid_khgemm_int8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID conv, stride 1, dilation 1, s8 compute with a float32 epilogue.

    :param x: ``[N, H, W, Cin]`` (NHWC)
    :param w: ``[kh, kw, Cin, Cout]`` (HWIO)
    :return: ``[N, H-kh+1, W-kw+1, Cout]`` in ``x``'s dtype

    The integer products are exact; the error comes from the two
    round-to-nearest steps, at most half a step of each scale per element.
    """
    N, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    Ho, Wo = H - kh + 1, W - kw + 1
    with torch.autocast(x.device.type, enabled=False):
        cols_q, rowscale = quantize_windows(x, kw)
        w_q, colscale = quantize_weights(w)
        out = None
        # one product per kernel row, the int8 rows sliced before it: the
        # partial stays [N, Ho, Wo, Cout] and no row of H - Ho is multiplied
        for i in range(kh):
            part = _s8_gemm(cols_q[:, i: i + Ho].reshape(-1, kw * Cin), w_q[:, i])
            term = part.view(N, Ho, Wo, Cout).float() * rowscale[:, i: i + Ho] * colscale[i]
            out = term if out is None else out + term
    return out.to(x.dtype)
