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

All entry points accept arbitrary leading batch dims over the last (sample)
axis.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpumix_torch.config import FrontendConfig

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


def _fused_frontend(cfg: FrontendConfig):
    """The fused ``(x, cfg) -> dB [..., frames, bins]`` frontend that ``cfg``
    resolves to, or None for ``"fft"``."""
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
    return _stft_mag_fft(x, cfg)


def spectrogram_features_tm(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """Frontend in time-major layout: ``[..., S]`` -> ``[..., frames, bins]``."""
    cfg = cfg or FrontendConfig()
    fused = _fused_frontend(cfg)
    if fused is not None:
        return fused(x, cfg)
    mag = _stft_mag_fft(x, cfg)
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
