"""Kernel K1: the decimation-in-frequency factorized STFT -> dB frontend.

Replaces the Pallas kernel ``stft_features_dif_pallas_tm``
(tpumix/ops/stft_dif_pallas.py:267, kernel body ``_dif_kernel`` :207), and
its CUDA kernel also serves the DIT entry (tpumix_torch/ops/stft_ct.py), the
same function.  With ``n = 128*n1 + n2`` and ``k = 16*k2 + k1`` the windowed
2048-point real DFT becomes

    y_k1[n2]    = sum_n1 (w*f)[128*n1 + n2] * W_16^(n1*k1)   (stage A, k1 <= 8)
    z_k1[n2]    = y_k1[n2] * W_2048^(k1*n2)                   (twiddle, k1 <= 8)
    X[16*k2+k1] = sum_n2 z_k1[n2] * W_128^(n2*k2)             (stage C, k2 < 128)

and the bins with ``k1 > 8`` are the mirrors ``X[16*k2 + k1] = conj
X[16*(127-k2) + 16-k1]`` of a real input (``_output_map``).  The epilogue
writes ``(mult/2)*log10(max(|X|^2, amin^2))``.  Frames are read from the
unpadded rows through the centre reflect padding's index map
(``_reflect_index``), so no padded copy exists.  The kernel runs stage A as a
real 16-point FFT and stage C as a radix-factored 128-point FFT; the plain
version runs both as DFT matmuls, which is the same function; both compute
in float64 and round once to float32 features.

``stft_features_dif`` launches the CUDA kernel (tpumix_torch/csrc/stft_dif.cu)
for a CUDA tensor and runs ``stft_features_dif_plain`` for a CPU tensor.  It
writes bins in natural order, so the JAX de-interleave
(stft_dif_pallas.py:342-345) has no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from tpumix_torch.config import FrontendConfig, dif_applicable
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
    csrc/stft_dif.cu), holds the ``W_16`` factors as literals and reads the
    twiddle rows ``k1 = 1..8`` only."""
    flat = np.concatenate([a.reshape(-1) for a in _dif_tables_f64(_KERNEL_NFFT)[:5]])
    return torch.from_numpy(flat).to(device)


def _check_length(S: int, n_fft: int) -> None:
    """Centre reflect padding needs more than ``n_fft // 2`` samples, as
    ``F.pad(mode="reflect")`` does."""
    if S <= n_fft // 2:
        raise ValueError(f"reflect padding of {n_fft // 2} needs more than {n_fft // 2} "
                         f"samples, got {S}")


def _reflect_index(S: int, T: int, hop: int, n_fft: int) -> torch.Tensor:
    """``[T, n_fft]``: the sample of the unpadded row that frame ``t`` reads at
    position ``n``.  Padded index ``j = t*hop + n`` is source ``i = j -
    n_fft/2``, reflected: ``i < 0 -> -i``, ``i > S-1 -> 2(S-1) - i``.  The
    kernel computes the same map per load."""
    i = (torch.arange(T)[:, None] * hop + torch.arange(n_fft)[None, :] - n_fft // 2).abs()
    return torch.where(i > S - 1, 2 * (S - 1) - i, i)


@functools.lru_cache(maxsize=8)
def _output_map(n_fft: int) -> torch.Tensor:
    """``[n_fft/2 + 1]``: for each onesided bin ``k = n1v*k2 + k1``, its flat
    index ``k1*128 + k2`` into the ``[k1u, 128]`` series of the real input's
    ``k1 <= n1v/2``; a bin with ``k1 > n1v/2`` reads its mirror ``(n1v - k1,
    127 - k2)``.  Each bin has one source, as it has one writer in the
    kernel."""
    n1v = n_fft // _N2
    k = np.arange(n_fft // 2 + 1)
    k1, k2 = k % n1v, k // n1v
    mirror = k1 > n1v // 2
    k1 = np.where(mirror, n1v - k1, k1)
    k2 = np.where(mirror, _N2 - 1 - k2, k2)
    return torch.from_numpy(k1 * _N2 + k2)


def _dif_db(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The kernel's factorization in float64 torch ops at any hop: ``[..., S]``
    -> ``[B, T, bins]`` float64 dB."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    n1v = n_fft // _N2
    k1u = n1v // 2 + 1
    lead, S = x.shape[:-1], x.shape[-1]
    _check_length(S, n_fft)
    T = 1 + S // hop
    B = int(np.prod(lead)) if lead else 1
    rows = x.reshape(B, S).to(torch.float64)
    dev = rows.device
    w, twc, tws, c128, s128, c16, s16 = (torch.from_numpy(a).to(dev) for a in _dif_tables_f64(n_fft))

    frames = rows[:, _reflect_index(S, T, hop, n_fft).to(dev)]  # [B, T, n_fft]
    f = frames.reshape(B, T, n1v, _N2) * w.view(n1v, _N2)
    # stage A over n1: [B, T, n2, n1] @ [n1, k1]
    ft = f.transpose(-1, -2)
    yre = (ft @ c16).transpose(-1, -2)  # [B, T, k1u, 128]
    yim = -(ft @ s16).transpose(-1, -2)
    zre = yre * twc[:k1u] + yim * tws[:k1u]
    zim = yim * twc[:k1u] - yre * tws[:k1u]
    # stage C: W_128^(n2*k2) for all 128 k2
    m = (torch.arange(_N2, device=dev)[:, None] * torch.arange(_N2, device=dev)[None, :]) % _N2
    C, Sn = c128[m], s128[m]  # [128, 128]
    xre = zre @ C + zim @ Sn
    xim = zim @ C - zre @ Sn
    m2 = (xre * xre + xim * xim).reshape(B, T, k1u * _N2)
    scale = 0.5 * cfg.db_multiplier / math.log(10.0)
    db = scale * torch.log(torch.clamp(m2, min=cfg.amin * cfg.amin))
    return db[:, :, _output_map(n_fft).to(dev)]


def stft_features_dif_plain(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """The kernel's factorization in torch ops: frames through the reflect
    index map, stage A as a ``[N1, 9]`` real DFT matmul, the twiddle, stage C
    as ``[128, 128]`` matmuls on the 9 series, the mirror for the other bins.
    ``[..., S]`` -> ``[..., T, bins]`` float32 on any device.

    It computes in float64 and rounds once at the end, as the kernel does:
    a float32 DFT is off by up to a few 0.1 dB in the quietest bins of a
    segment (a rounding of 1e-7 of the frame's energy against a bin 90 dB
    down), so float32 arithmetic here would hide the kernel's errors."""
    cfg = cfg or FrontendConfig()
    _check(cfg)
    db = _dif_db(x, cfg)
    return db.to(torch.float32).reshape(*x.shape[:-1], db.shape[1], cfg.num_bins)


def _check(cfg: FrontendConfig) -> None:
    if not dif_applicable(cfg):
        raise ValueError("the DIF frontend requires dif_applicable(cfg)")
    if cfg.pad_mode != "reflect":
        raise ValueError(f"the DIF frontend pads by reflection, got pad_mode={cfg.pad_mode!r}")


def launch_kernel(x: torch.Tensor, cfg: FrontendConfig, name: str, stages: int = 3) -> torch.Tensor:
    """One launch of the CUDA kernel on a CUDA tensor at ``cfg``'s hop: ``[...,
    S]`` -> ``[..., T, bins]``.  Both entries (this module's and
    ``stft_features_ct``) call it and count their own launches.

    ``stages`` 1 or 2 selects the measurement-only launch that stops after
    stage A or after C1 (``stft_dif_stages_launch``) and leaves the output
    unfinished."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32, got {x.dtype}")
    if cfg.n_fft != _KERNEL_NFFT:
        raise ValueError(f"the DIF kernel is built for n_fft={_KERNEL_NFFT}, got {cfg.n_fft}")
    if cfg.pad_mode != "reflect":
        raise ValueError(f"the DIF kernel pads by reflection, got pad_mode={cfg.pad_mode!r}")
    from tpumix_torch.ops import _build

    lead, S = x.shape[:-1], x.shape[-1]
    _check_length(S, cfg.n_fft)
    T = 1 + S // cfg.hop_length
    B = int(np.prod(lead)) if lead else 1
    rows = x.reshape(B, S).contiguous()
    out = torch.empty((B, T, cfg.num_bins), dtype=torch.float32, device=x.device)
    tables = _kernel_tables(str(x.device))
    lib = _build.load("stft_dif")
    args = (rows.data_ptr(), out.data_ptr(), tables.data_ptr(), B, T, S, cfg.hop_length,
            ctypes.c_float(0.5 * cfg.db_multiplier / math.log(10.0)),
            ctypes.c_double(cfg.amin * cfg.amin))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if stages == 3:
        err = lib.stft_dif_launch(*args, stream)
    else:
        err = lib.stft_dif_stages_launch(*args, stages, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    return out.reshape(*lead, T, cfg.num_bins)


def stft_features_dif(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """DIF frontend, time-major ``[..., S]`` -> ``[..., T, bins]`` float32.

    CUDA tensor: one launch of the hand-written kernel (``launches`` counts
    them).  CPU tensor: :func:`stft_features_dif_plain`."""
    cfg = cfg or FrontendConfig()
    _check(cfg)
    if x.device.type == "cpu":
        return stft_features_dif_plain(x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"stft_features_dif takes a CPU or CUDA tensor, got {x.device}")
    out = launch_kernel(x, cfg, "stft_dif")
    stft_features_dif.launches += 1
    return out


stft_features_dif.launches = 0

#: Kernel forward, ``"fft"``-path backward: the differentiable DIF frontend
#: (tpumix/ops/stft_dif_pallas.py ``stft_features_dif_tm_hybrid``).
stft_features_dif_tm_hybrid = make_tm_hybrid(stft_features_dif)
