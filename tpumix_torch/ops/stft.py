"""STFT -> dB-magnitude feature frontend (tpumix/ops/stft.py:55-96, 274-397).

Contract (reference data/dataset.py:132-162): ``torch.stft(n_fft=2048,
hop_length=H, window=hann(2048) periodic, center=True, reflect,
onesided)`` -> abs -> ``20*log10(max(|X|, 1e-5))``; ``[n_bins, frames]`` per
signal, ``1 + len // H`` frames.

Implementations behind one signature (``FrontendConfig.implementation``,
under the JAX package's names).  The three fused frontends compute dB
features directly, each as a hand-written CUDA kernel on the card and its
plain torch version on the CPU; ``"auto"`` picks the first that applies:

* ``"dif_pallas"`` — decimation-in-frequency factorized
  (tpumix_torch/ops/stft_dif.py); every model preset.
* ``"ct_pallas"`` — decimation-in-time factorized
  (tpumix_torch/ops/stft_ct.py); hops that are multiples of 16 but not of 128.
  On the card it launches the DIF kernel, which computes the same function
  at any hop; its plain version keeps the DIT factorization.
* ``"pallas"`` — the naive windowed basis (tpumix_torch/ops/stft_basis.py);
  any ``n_fft % hop == 0``.
* ``"fft"`` — ``torch.stft``, as the JAX ``fft`` path is XLA's FFT.
* ``"matmul"`` — the real DFT as one float32 product with a windowed
  ``[n_fft, 2*bins]`` cos / -sin basis (built in float64).
* ``"ct"`` — one Cooley-Tukey step of that product (n_fft = 16 phases x
  N2): a batched N2-point DFT of the phase frames, a complex twiddle and a
  16-point output DFT, all float32 products; ``"matmul"`` where
  ``ct_applicable`` fails.

``"matmul"`` and ``"ct"`` are XLA-level formulations in the JAX package
(tpumix/ops/stft.py:100-295), not Pallas kernels, so they are plain torch
here on every device, differentiable through autograd.  On the card their
products run in full float32 only where TF32 is off.

All entry points accept arbitrary leading batch dims over the last (sample)
axis.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpumix_torch.config import _CT_N1, FrontendConfig, ct_applicable

_LOG10_INV = 1.0 / math.log(10.0)


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window ``0.5 - 0.5*cos(2*pi*k/n)`` built in float64."""
    k = np.arange(n)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)
    return torch.as_tensor(w, dtype=dtype, device=device)


def pad_center(x: torch.Tensor, n_fft: int, pad_mode: str) -> torch.Tensor:
    """Pad ``n_fft // 2`` on both sides of the last axis.  ``F.pad``'s
    reflect mode wants a 2-D or 3-D input, so leading dims fold into one."""
    pad = n_fft // 2
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    return F.pad(flat, (pad, pad), mode=pad_mode).reshape(*lead, -1)


def padded_rows(x: torch.Tensor, cfg: FrontendConfig):
    """What the naive-basis kernel and the DIT plain version start from
    (the DIF kernel pads inside): ``[..., S]`` folded to float32
    rows ``[B, S + n_fft]``, centre-padded.  Returns ``(rows, leading shape,
    B, frame count 1 + S // hop)``."""
    lead = x.shape[:-1]
    S = x.shape[-1]
    T = 1 + S // cfg.hop_length
    B = int(np.prod(lead)) if lead else 1
    xp = pad_center(x.reshape(B, S).to(torch.float32), cfg.n_fft, cfg.pad_mode)
    return xp, lead, B, T


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int, *, center: bool = True,
                 pad_mode: str = "reflect") -> torch.Tensor:
    """Overlapping frames ``[..., 1 + S // hop, n_fft]`` of ``x [..., S]``
    (a strided view of the padded signal); ``center`` pads ``n_fft // 2`` on
    both sides first (torch.stft semantics)."""
    if center:
        x = pad_center(x, n_fft, pad_mode)
    return x.unfold(-1, n_fft, hop_length)


def amplitude_to_db(mag: torch.Tensor, amin: float = 1e-5, multiplier: float = 20.0,
                    db_multiplier: float = 0.0) -> torch.Tensor:
    """torchaudio.functional.amplitude_to_DB with top_db=None."""
    out = multiplier * torch.log(torch.clamp(mag, min=amin)) * _LOG10_INV
    if db_multiplier != 0.0:
        out = out - multiplier * db_multiplier
    return out


def _stft_mag_fft(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
    spec = torch.stft(
        flat, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        window=hann_window(cfg.n_fft, device=x.device), center=cfg.center,
        pad_mode=cfg.pad_mode, onesided=True, return_complex=True,
    )  # [B, bins, frames]
    return spec.abs().transpose(-1, -2).reshape(*lead, -1, cfg.num_bins)


@functools.lru_cache(maxsize=8)
def _dft_bases_np(n_fft: int, windowed: bool = True) -> np.ndarray:
    """Real-DFT basis ``[n_fft, 2*bins]``, columns ``[cos | -sin]`` with the
    Hann window folded in, so that ``frames @ basis = [real | imag]`` of the
    onesided DFT; built in float64, cast to float32."""
    bins = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    if windowed:
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
        basis = basis * w[:, None]
    return basis.astype(np.float32)


def _stft_mag_matmul(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    frames = frame_signal(x.to(torch.float32), cfg.n_fft, cfg.hop_length, center=cfg.center,
                          pad_mode=cfg.pad_mode)
    basis = torch.from_numpy(_dft_bases_np(cfg.n_fft)).to(x.device)
    ri = torch.matmul(frames, basis)  # [..., frames, 2*bins]
    bins = cfg.num_bins
    re, im = ri[..., :bins], ri[..., bins:]
    return torch.sqrt(re * re + im * im)


@functools.lru_cache(maxsize=8)
def _ct_bases_np(n_fft: int):
    """Factor bases of the Cooley-Tukey real DFT (float64, cast to float32).
    With ``n = N1*n2 + n1`` and ``k = N2*k1 + k2`` (N1 = 16 phases, N2 =
    n_fft / N1):

        X[N2*k1 + k2] = sum_n1 W_N1^(n1*k1) * W_N^(n1*k2)
                        * sum_n2 w[N1*n2 + n1] * x[N1*n2 + n1] * W_N2^(n2*k2)

    Returns ``(basis1 [N1, N2, 2*K2u], tw_re [N1, N2], tw_im [N1, N2],
    basis3 [2*N1, 2*K1u])`` with K2u = N2//2 + 1, K1u = N1//2 + 1."""
    n1v, n2v = _CT_N1, n_fft // _CT_N1
    k2u, k1u = n2v // 2 + 1, n1v // 2 + 1
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft)
    n2 = np.arange(n2v, dtype=np.float64)
    ang1 = 2.0 * np.pi * n2[:, None] * np.arange(k2u, dtype=np.float64)[None, :] / n2v
    wp = w.reshape(n2v, n1v).T  # [N1, N2]: the window folded per phase
    basis1 = np.concatenate([wp[:, :, None] * np.cos(ang1)[None],
                             wp[:, :, None] * -np.sin(ang1)[None]], axis=-1)
    p = np.arange(n1v, dtype=np.float64)
    angt = 2.0 * np.pi * p[:, None] * np.arange(n2v, dtype=np.float64)[None, :] / n_fft
    ang3 = 2.0 * np.pi * p[:, None] * np.arange(k1u, dtype=np.float64)[None, :] / n1v
    c3, s3 = np.cos(ang3), np.sin(ang3)
    # rows: q = p carries re2, q = N1 + p carries im2; columns [Xre | Xim]
    basis3 = np.block([[c3, -s3], [s3, c3]])
    return tuple(a.astype(np.float32) for a in (basis1, np.cos(angt), -np.sin(angt), basis3))


def ct_phase_frames(x: torch.Tensor, cfg: FrontendConfig):
    """Phase-decimated frames ``[B, N1, T, N2]`` float32 of ``x [..., S]``
    (tpumix/ops/stft.py:191-219): ``xph[b, p, m] = padded_x[b, N1*m + p]``,
    and within phase ``p`` frame ``t`` is rows ``t .. t + r - 1`` of
    ``hop / N1`` samples, ``r = n_fft / hop``.  Returns ``(frames_ph, leading
    shape, T)``."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    n1v = _CT_N1
    hop_ph, r, n2v = hop // n1v, n_fft // hop, n_fft // n1v
    lead, S = x.shape[:-1], x.shape[-1]
    T = 1 + S // hop
    B = int(np.prod(lead)) if lead else 1
    xp = pad_center(x.reshape(B, S).to(torch.float32), n_fft, cfg.pad_mode)
    xp = xp[:, : (T + r - 1) * hop]
    rows = xp.reshape(B, (T + r - 1) * hop // n1v, n1v).transpose(1, 2).reshape(
        B, n1v, T + r - 1, hop_ph)
    frames_ph = torch.stack([rows[:, :, j: j + T] for j in range(r)], dim=3)
    return frames_ph.reshape(B, n1v, T, n2v), lead, T


def _stft_mag_ct(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The Cooley-Tukey factorized real DFT (tpumix/ops/stft.py:222-271);
    ``"matmul"`` where :func:`ct_applicable` fails."""
    if not ct_applicable(cfg):
        return _stft_mag_matmul(x, cfg)
    n1v, n2v = _CT_N1, cfg.n_fft // _CT_N1
    k2u, k1u = n2v // 2 + 1, n1v // 2 + 1
    frames_ph, lead, T = ct_phase_frames(x, cfg)
    B = frames_ph.shape[0]
    b1, tw_re, tw_im, b3 = (torch.from_numpy(a).to(x.device) for a in _ct_bases_np(cfg.n_fft))
    a = torch.matmul(frames_ph, b1[None, :, :, :])  # [B, N1, T, 2*K2u]
    re, im = a[..., :k2u], a[..., k2u:]
    # conjugate-symmetric expansion of the real inner DFT to all N2 bins
    re_f = torch.cat([re, re[..., 1: n2v - k2u + 1].flip(-1)], dim=-1)
    im_f = torch.cat([im, -im[..., 1: n2v - k2u + 1].flip(-1)], dim=-1)
    tw_re, tw_im = tw_re[:, None, :], tw_im[:, None, :]
    re2 = re_f * tw_re - im_f * tw_im
    im2 = re_f * tw_im + im_f * tw_re
    z = torch.cat([re2.movedim(1, -1), im2.movedim(1, -1)], dim=-1)  # [B, T, N2, 2*N1]
    xo = torch.matmul(z, b3)  # [B, T, N2, 2*K1u]
    xre, xim = xo[..., :k1u], xo[..., k1u:]
    mag2 = xre * xre + xim * xim
    # k = N2*k1 + k2: k1-major flatten, then the onesided bins
    mag2 = mag2.movedim(-1, -2).reshape(B, T, k1u * n2v)[..., : cfg.num_bins]
    return torch.sqrt(mag2).reshape(*lead, T, cfg.num_bins)


_MAGNITUDE = {"matmul": _stft_mag_matmul, "ct": _stft_mag_ct, "fft": _stft_mag_fft}


def _fused_frontend(cfg: FrontendConfig):
    """The fused ``(x, cfg) -> dB [..., frames, bins]`` frontend that ``cfg``
    resolves to, or None for ``"fft"``, ``"matmul"`` and ``"ct"``."""
    impl = cfg.resolved_implementation()
    if impl == "dif_pallas":
        from tpumix_torch.ops.stft_dif import stft_features_dif

        return stft_features_dif
    if impl == "ct_pallas":
        from tpumix_torch.ops.stft_ct import stft_features_ct

        return stft_features_ct
    if impl == "pallas":
        from tpumix_torch.ops.stft_basis import stft_features_basis

        return stft_features_basis
    return None


def stft_magnitude(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """Magnitude spectrogram ``[..., frames, bins]``.  The fused frontends
    compute dB directly, so their magnitude is ``10**(dB/mult)``: sub-amin
    bins come back as exactly ``amin`` (identical after
    :func:`amplitude_to_db`)."""
    cfg = cfg or FrontendConfig()
    fused = _fused_frontend(cfg)
    if fused is not None:
        return torch.exp(fused(x, cfg) * (math.log(10.0) / cfg.db_multiplier))
    return _MAGNITUDE[cfg.resolved_implementation()](x, cfg)


def spectrogram_features_tm(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """Frontend in time-major layout: ``[..., S]`` -> ``[..., frames, bins]``."""
    cfg = cfg or FrontendConfig()
    fused = _fused_frontend(cfg)
    if fused is not None:
        return fused(x, cfg)
    mag = _MAGNITUDE[cfg.resolved_implementation()](x, cfg)
    return amplitude_to_db(mag, amin=cfg.amin, multiplier=cfg.db_multiplier)


def spectrogram_features(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """Full frontend: ``[..., S]`` -> dB features ``[..., bins, frames]``."""
    return spectrogram_features_tm(x, cfg).transpose(-1, -2)


def spectrogram_features_np(x: np.ndarray, cfg: Optional[FrontendConfig] = None) -> np.ndarray:
    """Pure-numpy mirror of :func:`spectrogram_features` (the conformance
    oracle).  Output ``[..., bins, frames]``."""
    cfg = cfg or FrontendConfig()
    x = np.asarray(x, dtype=np.float32)
    pad = cfg.n_fft // 2
    if cfg.center:
        xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode=cfg.pad_mode)
    else:
        xp = x
    num_frames = 1 + (xp.shape[-1] - cfg.n_fft) // cfg.hop_length
    strides = xp.strides[:-1] + (cfg.hop_length * xp.strides[-1], xp.strides[-1])
    frames = np.lib.stride_tricks.as_strided(
        xp, shape=xp.shape[:-1] + (num_frames, cfg.n_fft), strides=strides
    )
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(cfg.n_fft) / cfg.n_fft)).astype(np.float32)
    spec = np.fft.rfft(frames * w, axis=-1)
    mag = np.abs(spec).astype(np.float32)
    db = cfg.db_multiplier * np.log10(np.maximum(mag, cfg.amin))
    return np.swapaxes(db, -1, -2)
