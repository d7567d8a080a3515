"""Plain dB-magnitude frontend: ``torch.stft`` in float64 (periodic Hann,
centre, reflect, onesided) -> power -> ``10*log10(max(|X|^2, amin^2))``,
rounded once to float32 (the reference model's features,
deep-audio-mixer data/dataset.py, computed without float32 FFT error)."""

from __future__ import annotations

import math
from typing import Dict

import torch


def hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)


def features_db(x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """``x [..., S]`` -> ``[..., bins, frames]`` float32 dB features."""
    lead, S = x.shape[:-1], x.shape[-1]
    n_fft = cfg["n_fft"]
    spec = torch.stft(x.reshape(-1, S).to(torch.float64), n_fft=n_fft,
                      hop_length=cfg["hop_length"], window=hann(n_fft, x.device),
                      center=True, pad_mode="reflect", onesided=True, return_complex=True)
    power = spec.real.square() + spec.imag.square()
    db = 10.0 * torch.log10(torch.clamp(power, min=cfg["amin"] ** 2))
    return db.to(torch.float32).reshape(*lead, *db.shape[-2:])


def chunk_features(stems: torch.Tensor, first: int, count: int, cfg: Dict) -> torch.Tensor:
    """Features of chunks ``[first, first + count)`` of ``stems [stems, S]``:
    each chunk is its own signal, ``[count, stems, bins, frames]``."""
    C = cfg["chunk_samples"]
    x = stems[:, first * C:(first + count) * C].reshape(stems.shape[0], count, C)
    return features_db(x.transpose(0, 1), cfg)
