"""Kernel K1: the decimation-in-frequency factorized STFT -> dB frontend.

Replaces the Pallas kernel ``stft_features_dif_pallas_tm``
(tpumix/ops/stft_dif_pallas.py:267, kernel body ``_dif_kernel`` :207).  With
``n = 128*n1 + n2`` and ``k = 16*k2 + k1`` the windowed 2048-point real DFT
becomes

    y_k1[n2]    = sum_n1 (w*f)[128*n1 + n2] * W_16^(n1*k1)   (stage A, k1 <= 8)
    z_k1[n2]    = y_k1[n2] * W_2048^(k1*n2)                   (twiddle; k1 > 8 by
                                                               conjugate symmetry)
    X[16*k2+k1] = sum_n2 z_k1[n2] * W_128^(n2*k2)             (stage C)

and the epilogue writes ``(mult/2)*log10(max(|X|^2, amin^2))``.  The kernel
runs stage C as a radix-factored 128-point FFT and the plain version as one
``[128, 65]`` DFT, which is the same function; both compute in float64 and
round once to float32 features.

``stft_features_dif`` launches the CUDA kernel (tpumix_torch/csrc/stft_dif.cu)
for a CUDA tensor and runs ``stft_features_dif_plain`` — the same
factorization in torch ops — for a CPU tensor.  It writes bins in natural
order, so the JAX de-interleave (stft_dif_pallas.py:342-345) has no
counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from tpumix_torch.config import FrontendConfig, dif_applicable
from tpumix_torch.ops.stft import padded_rows
from tpumix_torch.ops.stft_basis import make_tm_hybrid

_N2 = 128  # contiguous block size (n = 128*n1 + n2)
_KERNEL_NFFT = 2048  # the CUDA kernel is specialised for 16 x 128


@functools.lru_cache(maxsize=8)
def _dif_tables_f64(n_fft: int):
    """``(window [n_fft], tw_cos [N1, 128], tw_sin [N1, 128], c128 [128],
    s128 [128], c16 [N1, K1u], s16 [N1, K1u])`` in float64.  ``c128[m] =
    cos(2*pi*m/128)`` serves every ``W_128^(n2*k2)`` through ``m = n2*k2 mod
    128``; stage-A factors below 1e-12 are exact zeros, as the JAX kernel
    elides them."""
    n1v = n_fft // _N2
    k1u = n1v // 2 + 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
    k1 = np.arange(n1v, dtype=np.float64)
    n2 = np.arange(_N2, dtype=np.float64)
    angt = 2.0 * np.pi * k1[:, None] * n2[None, :] / n_fft
    ang128 = 2.0 * np.pi * n2 / _N2
    n1 = np.arange(n1v, dtype=np.float64)
    angA = 2.0 * np.pi * n1[:, None] * np.arange(k1u, dtype=np.float64)[None, :] / n1v
    c16, s16 = np.cos(angA), np.sin(angA)
    c16[np.abs(c16) < 1e-12] = 0.0
    s16[np.abs(s16) < 1e-12] = 0.0
    return w, np.cos(angt), np.sin(angt), np.cos(ang128), np.sin(ang128), c16, s16


@functools.lru_cache(maxsize=8)
def _kernel_tables(device: str) -> torch.Tensor:
    """Window, twiddles and ``W_128`` in float64, in the kernel's flat order,
    resident on ``device``.  The kernel computes in float64 (see the note in
    csrc/stft_dif.cu) and holds the ``W_16`` factors as literals.  The DIT
    kernel (ops/stft_ct.py) reads the same buffer: its twiddle
    ``W_2048^(p*k2)`` is this ``[16, 128]`` table."""
    flat = np.concatenate([a.reshape(-1) for a in _dif_tables_f64(_KERNEL_NFFT)[:5]])
    return torch.from_numpy(flat).to(device)


def stft_features_dif_plain(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """The kernel's factorization in torch ops: stage A as a ``[N1, 9]`` real
    DFT matmul, the twiddle, stage C as ``[128, 65]`` matmuls.  ``[..., S]``
    -> ``[..., T, bins]`` float32 on any device.

    It computes in float64 and rounds once at the end, as the kernel does:
    a float32 DFT is off by up to a few 0.1 dB in the quietest bins of a
    segment (a rounding of 1e-7 of the frame's energy against a bin 90 dB
    down), so float32 arithmetic here would hide the kernel's errors."""
    cfg = cfg or FrontendConfig()
    if not dif_applicable(cfg):
        raise ValueError("the DIF frontend requires dif_applicable(cfg)")
    n_fft, hop = cfg.n_fft, cfg.hop_length
    n1v = n_fft // _N2
    k1u = n1v // 2 + 1
    k2u = (n_fft // 2) // n1v + 1
    xp, lead, B, T = padded_rows(x, cfg)
    xp = xp.to(torch.float64)
    dev = xp.device
    w, twc, tws, c128, s128, c16, s16 = (torch.from_numpy(a).to(dev) for a in _dif_tables_f64(n_fft))

    frames = xp.unfold(-1, n_fft, hop)[:, :T]  # [B, T, n_fft]
    f = frames.reshape(B, T, n1v, _N2) * w.view(n1v, _N2)
    # stage A over n1: [B, T, n2, n1] @ [n1, k1]
    ft = f.transpose(-1, -2)
    yre = (ft @ c16).transpose(-1, -2)  # [B, T, k1u, 128]
    yim = -(ft @ s16).transpose(-1, -2)
    mirror = list(range(n1v - k1u, 0, -1))  # k1 > N1/2: y_k1 = conj(y_{N1-k1})
    yre = torch.cat([yre, yre[:, :, mirror]], dim=2)  # [B, T, N1, 128]
    yim = torch.cat([yim, -yim[:, :, mirror]], dim=2)
    zre = yre * twc + yim * tws
    zim = yim * twc - yre * tws
    # stage C: W_128^(n2*k2) for the onesided k2 < k2u
    m = (torch.arange(_N2, device=dev)[:, None] * torch.arange(k2u, device=dev)[None, :]) % _N2
    C, Sn = c128[m], s128[m]  # [128, k2u]
    xre = zre @ C + zim @ Sn
    xim = zim @ C - zre @ Sn
    m2 = xre * xre + xim * xim  # [B, T, N1, k2u]
    scale = 0.5 * cfg.db_multiplier / math.log(10.0)
    db = scale * torch.log(torch.clamp(m2, min=cfg.amin * cfg.amin))
    out = db.transpose(-1, -2).reshape(B, T, k2u * n1v)[:, :, : cfg.num_bins]
    return out.to(torch.float32).reshape(*lead, T, cfg.num_bins)


def stft_features_dif(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """DIF frontend, time-major ``[..., S]`` -> ``[..., T, bins]`` float32.

    CUDA tensor: one launch of the hand-written kernel (``launches`` counts
    them).  CPU tensor: :func:`stft_features_dif_plain`."""
    cfg = cfg or FrontendConfig()
    if not dif_applicable(cfg):
        raise ValueError("the DIF frontend requires dif_applicable(cfg)")
    if x.device.type == "cpu":
        return stft_features_dif_plain(x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"stft_features_dif takes a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"stft_features_dif kernel takes float32, got {x.dtype}")
    if cfg.n_fft != _KERNEL_NFFT:
        raise ValueError(f"the DIF kernel is built for n_fft={_KERNEL_NFFT}, got {cfg.n_fft}")
    from tpumix_torch.ops import _build

    xp, lead, B, T = padded_rows(x, cfg)
    xp = xp.contiguous()
    out = torch.empty((B, T, cfg.num_bins), dtype=torch.float32, device=x.device)
    tables = _kernel_tables(str(x.device))
    lib = _build.load("stft_dif")
    err = lib.stft_dif_launch(
        xp.data_ptr(), out.data_ptr(), tables.data_ptr(), B, T, xp.shape[-1],
        cfg.hop_length, ctypes.c_float(0.5 * cfg.db_multiplier / math.log(10.0)),
        ctypes.c_double(cfg.amin * cfg.amin), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stft_dif kernel launch failed: cudaError_t {err}")
    stft_features_dif.launches += 1
    return out.reshape(*lead, T, cfg.num_bins)


stft_features_dif.launches = 0

#: Kernel forward, ``"fft"``-path backward: the differentiable DIF frontend
#: (tpumix/ops/stft_dif_pallas.py ``stft_features_dif_tm_hybrid``).
stft_features_dif_tm_hybrid = make_tm_hybrid(stft_features_dif)
