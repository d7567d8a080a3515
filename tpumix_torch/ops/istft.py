"""Inverse STFT (overlap-add) and spectral-domain reconstruction
(tpumix/ops/istft.py).

* :func:`stft_complex` — the complex STFT ``[..., frames, bins]`` of the
  frontend (periodic Hann, ``center``, reflect);
* :func:`istft` — its inverse: windowed overlap-add divided by the summed
  squared window, the centre padding trimmed, ``length`` cropped or
  zero-extended;
* :func:`reconstruct_from_magnitude` — magnitude + phase -> waveform;
* :func:`mix_in_spectrogram_domain` — gain-weighted complex-stem sum ->
  waveform.

The overlap-add is written out (``irfft``, window, ``index_add_``), as the
JAX function is its own overlap-add: ``torch.istft`` enforces a NOLA check
and trims differently.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpumix_torch.config import FrontendConfig
from tpumix_torch.ops.stft import frame_signal, hann_window


def stft_complex(x: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """Complex STFT ``[..., frames, bins]`` (time-major), torch.stft parity."""
    cfg = cfg or FrontendConfig()
    frames = frame_signal(x, cfg.n_fft, cfg.hop_length, center=cfg.center, pad_mode=cfg.pad_mode)
    window = hann_window(cfg.n_fft, dtype=frames.dtype, device=frames.device)
    return torch.fft.rfft(frames * window, dim=-1)


def istft(spec: torch.Tensor, cfg: Optional[FrontendConfig] = None,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT of ``[..., frames, bins]`` complex spectra -> ``[..., samples]``
    float32: windowed overlap-add over ``max(sum(w^2), 1e-11)``; with
    ``center`` the ``n_fft // 2`` padding is trimmed.  ``length`` crops or
    zero-extends the output (torch.istft's ``length=``)."""
    cfg = cfg or FrontendConfig()
    n_fft, hop = cfg.n_fft, cfg.hop_length
    w = hann_window(n_fft, dtype=torch.float32, device=spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1).to(torch.float32) * w  # [..., T, n_fft]
    T = frames.shape[-2]
    out_len = n_fft + hop * (T - 1)
    lead = frames.shape[:-2]
    fr = frames.reshape(-1, T * n_fft)
    idx = (torch.arange(T, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    y = torch.zeros(fr.shape[0], out_len, dtype=torch.float32, device=spec.device)
    y = y.index_add(1, idx, fr)
    wsq = torch.zeros(out_len, dtype=torch.float32, device=spec.device)
    wsq = wsq.index_add(0, idx, (w * w).expand(T, n_fft).reshape(-1))
    y = y / torch.clamp(wsq, min=1e-11)
    if cfg.center:
        pad = n_fft // 2
        y = y[:, pad: out_len - pad]
    if length is not None:
        cur = y.shape[-1]
        y = y[:, :length] if length <= cur else F.pad(y, (0, length - cur))
    return y.reshape(*lead, y.shape[-1])


def reconstruct_from_magnitude(mag: torch.Tensor, phase: torch.Tensor,
                               cfg: Optional[FrontendConfig] = None,
                               length: Optional[int] = None) -> torch.Tensor:
    """Magnitude (linear) + phase (radians), both ``[..., T, bins]`` ->
    waveform: the reference's stem-magnitude + mix-phase experiment
    (experiments.ipynb cells 44-53)."""
    return istft(mag * torch.exp(1j * phase), cfg, length=length)


def mix_in_spectrogram_domain(stem_specs: torch.Tensor, gains: torch.Tensor,
                              cfg: Optional[FrontendConfig] = None,
                              length: Optional[int] = None) -> torch.Tensor:
    """Gain-weighted complex-spectrogram mixdown: ``[..., S, T, bins]`` stems
    x ``[..., S]`` gains -> waveform."""
    mixed = torch.einsum("...stb,...s->...tb", stem_specs, gains.to(stem_specs.dtype))
    return istft(mixed, cfg, length=length)
