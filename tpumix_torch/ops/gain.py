"""Gain math (tpumix/ops/gain.py:27-45)."""

from __future__ import annotations

import torch

_LN10 = 2.302585092994046


def db_to_amplitude(x: torch.Tensor) -> torch.Tensor:
    """``10 ** (0.5 * x)`` (reference dataset_utils.py:46-50)."""
    return torch.exp((0.5 * _LN10) * x)


def spectral_mix(stem_features: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Gain-weighted sum of stem spectrograms: ``[..., S, F, T]`` x ``[...,
    S]`` -> ``[..., F, T]`` (dB domain during training, reference quirk)."""
    return torch.einsum("...sft,...s->...ft", stem_features, gains)
