"""Kernel K3: the naive windowed-basis STFT -> dB frontend, and the factory
that makes a fused frontend differentiable.

Replaces the Pallas kernel ``stft_features_pallas_tm``
(tpumix/ops/stft_pallas.py:119, kernel body ``_stft_kernel`` :64): each frame
of the centre-padded signal against the windowed real-DFT bases

    re[k] = sum_n x[t*hop + n] * w[n] *  cos(2 pi n k / n_fft)
    im[k] = sum_n x[t*hop + n] * w[n] * -sin(2 pi n k / n_fft)

then ``mult * log10(max(sqrt(re^2 + im^2), amin))``.  It takes any ``n_fft %
hop == 0`` and is the frontend for hops (and ``n_fft``) the other two fused
frontends cannot take.

The dense product is the TPU kernel's tactic, not the function.  On the card
``stft_features_basis`` launches a CUDA kernel (tpumix_torch/csrc/stft_basis.cu)
that computes the same DFT factorized, ``n_fft = 16^a * r``: ``a`` radix-16
stages in shared memory, then a dense ``r``-point DFT (``r`` = 8 for 2048, 1
for 256 and 4096, 75 for 1200), using the real input's symmetry, for any
``n_fft % 16 == 0`` whose frame fits in shared memory (about 19 bytes per
sample of the 227 KB a block may use: ``n_fft`` up to about 12000; beyond that
the launcher runs the tiled dense kernel of the same source).  For a CPU tensor the wrapper runs ``stft_features_basis_plain``, the
dense float64 matmul, which is the accuracy reference the kernel is held to.
``stft_features_basis_factorized_plain`` follows the kernel's factorization
stage by stage in torch ops, so its index math is testable on any host.  All
compute in float64 and round once to float32 features (see the note in the
kernel source).

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

_BIN_TILE = 64  # the dense kernel's bin tile: the bases come padded to a multiple
_RADIX = 16  # the factorized kernel peels radix-16 stages; the dense one walks n in steps of 16


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


def factorization(n_fft: int):
    """``(a, r)`` with ``n_fft == 16**a * r`` and ``r % 16 != 0``: the
    radix-16 stages the kernel peels and the length of its dense tail."""
    a, r = 0, n_fft
    while r % _RADIX == 0:
        a, r = a + 1, r // _RADIX
    return a, r


@functools.lru_cache(maxsize=4)
def _factor_tables_f64(n_fft: int):
    """``(window [n_fft], twiddle [n_fft, 2])`` in float64: the periodic Hann
    window and ``(cos, sin)(2 pi e / n_fft)``, from which every stage's
    twiddle ``W_L^(n2 k1) = W_n_fft^(n_fft/L n2 k1)`` and the tail's
    ``W_r^(m k)`` are read."""
    e = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * e / n_fft
    return 0.5 - 0.5 * np.cos(ang), np.stack([np.cos(ang), np.sin(ang)], axis=1)


@functools.lru_cache(maxsize=4)
def _kernel_tables(n_fft: int, device: str) -> torch.Tensor:
    """The factorized kernel's flat float64 table on ``device``: the window,
    then the twiddles interleaved ``cos, sin`` (``3 * n_fft`` values)."""
    w, tw = _factor_tables_f64(n_fft)
    return torch.from_numpy(np.concatenate([w, tw.reshape(-1)])).to(device)


def _digit_reverse(idx: np.ndarray, a: int) -> np.ndarray:
    """Reverse the ``a`` base-16 digits of ``idx``."""
    out = np.zeros_like(idx)
    for _ in range(a):
        out, idx = out * _RADIX + idx % _RADIX, idx // _RADIX
    return out


@functools.lru_cache(maxsize=4)
def _output_map(n_fft: int):
    """Where the factorized DFT's results land: ``(bin, keep)``, each
    ``[n_fft // r, r]`` over (subsequence, tail output).  Subsequence ``idx``
    (its base-16 digits are the stages' ``k1``, the first stage's leading)
    and tail output ``kr`` hold ``X[k]``, ``k = reverse(idx) + 16^a kr``.  The
    input is real, so ``|X[n_fft - k]| = |X[k]|``: only subsequences whose
    first digit is at most 8 are computed, and a result goes to bin
    ``min(k, n_fft - k)``; first digits 0 and 8 meet both ``k`` and ``n_fft -
    k`` themselves and keep the lower one only.  Every bin is kept once."""
    a, r = factorization(n_fft)
    idx = np.arange(n_fft // r)[:, None]
    k = _digit_reverse(idx, a) + _RADIX ** a * np.arange(r)[None, :]
    top = idx // _RADIX ** (a - 1)
    keep = (top <= 8) & (((top >= 1) & (top <= 7)) | (k <= n_fft // 2))
    return np.minimum(k, n_fft - k), keep


def _check(cfg: FrontendConfig) -> None:
    if cfg.n_fft % cfg.hop_length != 0:
        raise ValueError("the naive-basis frontend requires n_fft % hop_length == 0")


def _dense_db(x: torch.Tensor, cfg: FrontendConfig, dtype: torch.dtype):
    """dB features ``[B, T, bins]`` in ``dtype`` (not yet rounded to float32),
    the leading dims and T."""
    xp, lead, B, T = padded_rows(x, cfg)
    xp = xp.to(dtype)
    cos, sin = (torch.from_numpy(a).to(device=xp.device, dtype=dtype) for a in _bases_f64(cfg.n_fft))
    frames = xp.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :T]  # [B, T, n_fft]
    ri = frames @ torch.cat([cos, sin], dim=1)  # [B, T, 2*bins]
    re, im = ri[..., : cfg.num_bins], ri[..., cfg.num_bins:]
    mag = torch.sqrt(re * re + im * im)
    db = (cfg.db_multiplier / math.log(10.0)) * torch.log(torch.clamp(mag, min=cfg.amin))
    return db, lead, T


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
    db, lead, T = _dense_db(x, cfg, dtype)
    return db.to(torch.float32).reshape(*lead, T, cfg.num_bins)


def _factorized_db(x: torch.Tensor, cfg: FrontendConfig):
    """dB features ``[B, T, bins]`` in float64 by the kernel's factorization,
    the leading dims and T."""
    n_fft = cfg.n_fft
    if n_fft % _RADIX != 0:
        raise ValueError(f"the factorization needs n_fft % {_RADIX} == 0, got {n_fft}")
    a, r = factorization(n_fft)
    xp, lead, B, T = padded_rows(x, cfg)
    w, tw = (torch.from_numpy(t).to(xp.device) for t in _factor_tables_f64(n_fft))
    tw = torch.complex(tw[:, 0], -tw[:, 1])  # W_n_fft^e
    frames = xp.to(torch.float64).unfold(-1, n_fft, cfg.hop_length)[:, :T] * w  # [B, T, n_fft]
    y = torch.complex(frames, torch.zeros_like(frames))
    k16 = torch.arange(_RADIX, device=xp.device)
    w16 = tw[(n_fft // _RADIX) * (k16[:, None] * k16[None, :]) % n_fft]  # [k1, n1]
    for s in range(a):
        L = n_fft // _RADIX ** s
        M = L // _RADIX
        y = y.reshape(B, T, _RADIX ** s, _RADIX, M)  # [.., j, n1, n2]
        y = torch.einsum("kn,btjnm->btjkm", w16, y)
        e = (_RADIX ** s) * k16[:, None] * torch.arange(M, device=xp.device)[None, :]  # < n_fft
        y = y * tw[e]
    y = y.reshape(B, T, n_fft // r, r)
    kr = torch.arange(r, device=xp.device)
    tail = tw[(n_fft // r) * (kr[:, None] * kr[None, :]) % n_fft]  # [kr, m]
    X = torch.einsum("km,btim->btik", tail, y)
    power = X.real * X.real + X.imag * X.imag
    bins_of, keep = (torch.from_numpy(t).to(xp.device) for t in _output_map(n_fft))
    out = torch.empty((B, T, cfg.num_bins), dtype=torch.float64, device=xp.device)
    out[:, :, bins_of[keep]] = power[:, :, keep]
    db = (0.5 * cfg.db_multiplier / math.log(10.0)) * torch.log(
        torch.clamp(out, min=cfg.amin * cfg.amin))
    return db, lead, T


def stft_features_basis_factorized_plain(x: torch.Tensor,
                                         cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """The factorized kernel's arithmetic, stage by stage, in float64 torch
    ops: ``[..., S]`` -> ``[..., T, bins]`` float32 on any device.

    Stage ``s`` (``L = n_fft / 16^s``, ``M = L / 16``) takes every length-``L``
    subsequence as ``[16 (n1), M (n2)]``, runs the 16-point DFT over ``n1``,
    multiplies by ``W_L^(n2 k1)`` and leaves ``[16 (k1), M (n2)]`` in place;
    after ``a`` stages the length-``r`` subsequences get a dense DFT, and
    :func:`_output_map` says which results go to which bin."""
    cfg = cfg or FrontendConfig()
    _check(cfg)
    db, lead, T = _factorized_db(x, cfg)
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
    if cfg.n_fft % _RADIX != 0:
        raise ValueError(f"the naive-basis kernel needs n_fft % {_RADIX} == 0, got {cfg.n_fft}")
    from tpumix_torch.ops import _build

    xp, lead, B, T = padded_rows(x, cfg)
    xp = xp.contiguous()
    out = torch.empty((B, T, cfg.num_bins), dtype=torch.float32, device=x.device)
    lib = _build.load("stft_basis")
    tab = _kernel_tables(cfg.n_fft, str(x.device))
    # the launcher takes the factorized kernel where a frame fits in shared
    # memory; only past that does it read the dense bases
    dense = lib.stft_basis_route(cfg.n_fft) == 0
    cosb, sinb = _kernel_bases(cfg.n_fft, str(x.device)) if dense else (None, None)
    err = lib.stft_basis_launch(
        xp.data_ptr(), out.data_ptr(), tab.data_ptr(),
        cosb.data_ptr() if dense else None, sinb.data_ptr() if dense else None, B, T,
        xp.shape[-1], cfg.hop_length, cfg.n_fft, cfg.num_bins,
        cosb.shape[1] if dense else 0,
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
