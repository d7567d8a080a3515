"""Kernel K4: the decimation-in-time factorized STFT -> dB frontend.

Replaces the Pallas kernel ``stft_features_ct_pallas_tm``
(tpumix/ops/stft_ct_pallas.py:147, kernel body ``_ct_kernel`` :93).  With
``n = 16*n2 + p`` and ``k = 128*k1 + k2`` the windowed 2048-point real DFT
becomes

    A_p[k2]      = sum_n2 (w*f)[16*n2 + p] * W_128^(n2*k2)    (stage 1, per phase p)
    B_p[k2]      = A_p[k2] * W_2048^(p*k2)                     (twiddle)
    X[128*k1+k2] = sum_p B_p[k2] * W_16^(p*k1)                 (stage 3, k1 <= 8)

and the epilogue writes ``mult * log10(max(|X|, amin))``; the bins come out
k1-major, which is natural order.  It applies where ``ct_applicable(cfg)``
(``n_fft % hop == 0``, ``hop % 16 == 0``, centre padding) and is what
``"auto"`` picks for hops that are multiples of 16 but not of 128.

``stft_features_ct`` launches the DIF kernel (tpumix_torch/csrc/stft_dif.cu)
for a CUDA tensor: on Hopper neither reason for a second factorization holds
(Mosaic's stride-16 slices, the DIF kernel's 128-aligned ones), that kernel
reads a frame at any hop and computes the same function, so the JAX
package's prebuilt ``[B, 16, T, 128]`` phase-frame tensor and the DIT
kernel itself have no counterpart.  For a CPU tensor it runs
``stft_features_ct_plain``, the DIT factorization as matmuls in float64,
which stays the accuracy reference the kernel is held to at these hops.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from tpumix_torch.config import _CT_N1, FrontendConfig, ct_applicable
from tpumix_torch.ops.stft import padded_rows
from tpumix_torch.ops.stft_basis import make_tm_hybrid
from tpumix_torch.ops.stft_dif import launch_kernel


@functools.lru_cache(maxsize=8)
def _ct_tables_f64(n_fft: int):
    """``(b1 [N1, N2, 2*N2], tw_cos [N1, N2], tw_sin [N1, N2], c3 [N1, K1u],
    s3 [N1, K1u])`` in float64 (tpumix/ops/stft_ct_pallas.py
    ``_ct_kernel_bases_np``): the windowed per-phase inner basis ``[cos |
    -sin]`` at all N2 inner bins, the twiddle ``W_N^(p*k2) = tw_cos - i
    tw_sin`` and the outer factors ``W_N1^(p*k1) = c3 - i s3``."""
    n1v, n2v = _CT_N1, n_fft // _CT_N1
    k1u = n1v // 2 + 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
    wp = w.reshape(n2v, n1v).T  # [N1, N2]: w[N1*n2 + p]
    n2 = np.arange(n2v, dtype=np.float64)
    ang1 = 2.0 * np.pi * n2[:, None] * n2[None, :] / n2v  # [N2 (n2), N2 (k2)]
    b1 = np.concatenate(
        [wp[:, :, None] * np.cos(ang1)[None], wp[:, :, None] * -np.sin(ang1)[None]], axis=-1
    )
    p = np.arange(n1v, dtype=np.float64)
    angt = 2.0 * np.pi * p[:, None] * n2[None, :] / n_fft
    ang3 = 2.0 * np.pi * p[:, None] * np.arange(k1u, dtype=np.float64)[None, :] / n1v
    return b1, np.cos(angt), np.sin(angt), np.cos(ang3), np.sin(ang3)


def _check(cfg: FrontendConfig) -> None:
    if not ct_applicable(cfg):
        raise ValueError("the DIT frontend requires ct_applicable(cfg)")


def stft_features_ct_plain(x: torch.Tensor, cfg: Optional[FrontendConfig] = None,
                           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The kernel's factorization in torch ops: stage 1 as one ``[128, 256]``
    matmul per phase, the twiddle, stage 3 as a ``[16, 9]`` complex DFT.
    ``[..., S]`` -> ``[..., T, bins]`` float32 on any device.

    ``dtype`` is the arithmetic's: float64 is the accuracy reference the
    kernel is held to; float32 shows what these stages lose in single
    precision."""
    cfg = cfg or FrontendConfig()
    _check(cfg)
    n_fft = cfg.n_fft
    n1v, n2v = _CT_N1, n_fft // _CT_N1
    k1u = n1v // 2 + 1
    xp, lead, B, T = padded_rows(x, cfg)
    xp = xp.to(dtype)
    b1, twc, tws, c3, s3 = (torch.from_numpy(a).to(device=xp.device, dtype=dtype)
                            for a in _ct_tables_f64(n_fft))

    frames = xp.unfold(-1, n_fft, cfg.hop_length)[:, :T]  # [B, T, n_fft], n = 16*n2 + p
    ph = frames.reshape(B, T, n2v, n1v)  # [B, T, n2, p]
    a = torch.einsum("btnp,pnk->btpk", ph, b1)  # [B, T, p, 2*N2]
    re, im = a[..., :n2v], a[..., n2v:]
    re2 = re * twc + im * tws  # (re + i im) * (cos - i sin)
    im2 = im * twc - re * tws
    xre = torch.einsum("btpk,pl->btlk", re2, c3) + torch.einsum("btpk,pl->btlk", im2, s3)
    xim = torch.einsum("btpk,pl->btlk", im2, c3) - torch.einsum("btpk,pl->btlk", re2, s3)
    mag = torch.sqrt(xre * xre + xim * xim)  # [B, T, k1, k2]
    db = (cfg.db_multiplier / math.log(10.0)) * torch.log(torch.clamp(mag, min=cfg.amin))
    out = db.reshape(B, T, k1u * n2v)[:, :, : cfg.num_bins]  # k = N2*k1 + k2
    return out.to(torch.float32).reshape(*lead, T, cfg.num_bins)


def stft_features_ct(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """DIT frontend, time-major ``[..., S]`` -> ``[..., T, bins]`` float32.

    CUDA tensor: one launch of the DIF kernel at this hop (``launches``
    counts them).  CPU tensor: :func:`stft_features_ct_plain`."""
    cfg = cfg or FrontendConfig()
    _check(cfg)
    if x.device.type == "cpu":
        return stft_features_ct_plain(x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"stft_features_ct takes a CPU or CUDA tensor, got {x.device}")
    out = launch_kernel(x, cfg, "stft_ct")
    stft_features_ct.launches += 1
    return out


stft_features_ct.launches = 0

#: Kernel forward, ``"fft"``-path backward: the differentiable DIT frontend
#: (tpumix/ops/stft_ct_pallas.py ``stft_features_ct_tm_hybrid``).
stft_features_ct_tm_hybrid = make_tm_hybrid(stft_features_ct)
