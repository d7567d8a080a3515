"""Kernel K3: the naive windowed-basis STFT -> dB frontend, and the factory
that makes a fused frontend differentiable.

Replaces the Pallas kernel ``stft_features_pallas_tm``
(tpumix/ops/stft_pallas.py:119, kernel body ``_stft_kernel`` :64): each frame
of the centre-padded signal against the windowed real-DFT bases

    re[k] = sum_n x[t*hop + n] * w[n] *  cos(2 pi n k / n_fft)
    im[k] = sum_n x[t*hop + n] * w[n] * -sin(2 pi n k / n_fft)

then ``mult * log10(max(sqrt(re^2 + im^2), amin))``.  It takes any ``n_fft %
hop == 0`` and is the fallback for hops the factorized frontends cannot take;
at ``4 * n_fft * bins`` flops per frame it is by far the most expensive of the
three.

``stft_features_basis`` launches the CUDA kernel
(tpumix_torch/csrc/stft_basis.cu) for a CUDA tensor and runs
``stft_features_basis_plain`` for a CPU tensor.  Both compute in float64 and
round once to float32 features (see the note in the kernel source).

``make_tm_hybrid`` (tpumix/ops/stft_pallas.py:206) wraps any of the three
fused frontends in a ``torch.autograd.Function``: the fused forward, and a
backward that is the VJP of the ``"fft"`` path, so a gradient never re-enters
a kernel.  None of the kernels has a backward kernel, in either package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from tpumix_torch.config import FrontendConfig
from tpumix_torch.ops.stft import _stft_mag_fft, amplitude_to_db, padded_rows

_BIN_TILE = 64  # the kernel's bin tile: the bases come padded to a multiple
_K_TILE = 16  # the kernel walks n in steps of 16


@functools.lru_cache(maxsize=4)
def _bases_f64(n_fft: int):
    """Windowed ``(cos, -sin)`` bases ``[n_fft, bins]`` in float64
    (tpumix/ops/stft.py ``_dft_bases_np``, before its cast to float32)."""
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
    return np.cos(ang) * w[:, None], -np.sin(ang) * w[:, None]


@functools.lru_cache(maxsize=4)
def _kernel_bases(n_fft: int, device: str):
    """The bases zero-padded on the bin axis to the kernel's tile, resident on
    ``device``: ``(cos, -sin)``, each ``[n_fft, bins_padded]`` float64."""
    bins = n_fft // 2 + 1
    padded = -(-bins // _BIN_TILE) * _BIN_TILE
    out = []
    for basis in _bases_f64(n_fft):
        full = np.zeros((n_fft, padded), np.float64)
        full[:, :bins] = basis
        out.append(torch.from_numpy(full).to(device))
    return tuple(out)


def _check(cfg: FrontendConfig) -> None:
    if cfg.n_fft % cfg.hop_length != 0:
        raise ValueError("the naive-basis frontend requires n_fft % hop_length == 0")


def stft_features_basis_plain(x: torch.Tensor, cfg: Optional[FrontendConfig] = None,
                              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The kernel's function in torch ops: overlapping frames as a strided
    view, one matmul against ``[n_fft, 2*bins]``, magnitude, clamp, dB.
    ``[..., S]`` -> ``[..., T, bins]`` float32 on any device.

    ``dtype`` is the arithmetic's: float64 is the accuracy reference the
    kernel is held to; float32 shows what this sum of ``n_fft`` terms loses in
    single precision."""
    cfg = cfg or FrontendConfig()
    _check(cfg)
    xp, lead, B, T = padded_rows(x, cfg)
    xp = xp.to(dtype)
    cos, sin = (torch.from_numpy(a).to(device=xp.device, dtype=dtype) for a in _bases_f64(cfg.n_fft))
    frames = xp.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :T]  # [B, T, n_fft]
    ri = frames @ torch.cat([cos, sin], dim=1)  # [B, T, 2*bins]
    re, im = ri[..., : cfg.num_bins], ri[..., cfg.num_bins:]
    mag = torch.sqrt(re * re + im * im)
    db = (cfg.db_multiplier / math.log(10.0)) * torch.log(torch.clamp(mag, min=cfg.amin))
    return db.to(torch.float32).reshape(*lead, T, cfg.num_bins)


def stft_features_basis(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """Naive-basis frontend, time-major ``[..., S]`` -> ``[..., T, bins]``
    float32.

    CUDA tensor: one launch of the hand-written kernel (``launches`` counts
    them).  CPU tensor: :func:`stft_features_basis_plain`."""
    cfg = cfg or FrontendConfig()
    _check(cfg)
    if x.device.type == "cpu":
        return stft_features_basis_plain(x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"stft_features_basis takes a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"stft_features_basis kernel takes float32, got {x.dtype}")
    if cfg.n_fft % _K_TILE != 0:
        raise ValueError(f"the naive-basis kernel needs n_fft % {_K_TILE} == 0, got {cfg.n_fft}")
    from tpumix_torch.ops import _build

    xp, lead, B, T = padded_rows(x, cfg)
    xp = xp.contiguous()
    out = torch.empty((B, T, cfg.num_bins), dtype=torch.float32, device=x.device)
    cosb, sinb = _kernel_bases(cfg.n_fft, str(x.device))
    lib = _build.load("stft_basis")
    err = lib.stft_basis_launch(
        xp.data_ptr(), out.data_ptr(), cosb.data_ptr(), sinb.data_ptr(), B, T, xp.shape[-1],
        cfg.hop_length, cfg.n_fft, cfg.num_bins, cosb.shape[1],
        ctypes.c_float(0.5 * cfg.db_multiplier / math.log(10.0)),
        ctypes.c_double(cfg.amin * cfg.amin), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stft_basis kernel launch failed: cudaError_t {err}")
    stft_features_basis.launches += 1
    return out.reshape(*lead, T, cfg.num_bins)


stft_features_basis.launches = 0


def _tm_fft(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The differentiable mirror behind every hybrid's backward: the
    ``"fft"`` path, pinned explicitly (``torch.stft`` -> ``abs`` -> dB) so that
    ``"auto"`` can never send a backward into a kernel
    (tpumix/ops/stft_pallas.py ``_tm_jnp``)."""
    cfg = dataclasses.replace(cfg, implementation="fft")
    return amplitude_to_db(_stft_mag_fft(x, cfg), amin=cfg.amin, multiplier=cfg.db_multiplier)


def make_tm_hybrid(forward: Callable) -> Callable:
    """Wrap a time-major fused frontend ``forward(x, cfg)`` so that it can be
    differentiated: ``forward`` gives the values, the ``"fft"`` path the
    gradient with respect to ``x``.  All three fused frontends share this
    one factory."""

    class _Hybrid(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, cfg):
            ctx.save_for_backward(x)
            ctx.cfg = cfg
            return forward(x, cfg)

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                y = _tm_fft(xx, ctx.cfg)
            (gx,) = torch.autograd.grad(y, xx, g)
            return gx, None

    def hybrid(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
        return _Hybrid.apply(x, cfg or FrontendConfig())

    return hybrid


#: Kernel forward, ``"fft"``-path backward: the differentiable naive-basis
#: frontend in time-major layout.
stft_features_tm_hybrid = make_tm_hybrid(stft_features_basis)
