"""Gain / mixdown math (tpumix/ops/gain.py): dB<->amplitude converters, the
spectral mix-sum, the DummyModel baseline and random-gain augmentation.

Where the JAX package takes a PRNG key, these take an explicit
``torch.Generator``; random tensors are drawn on the generator's device, so a
generator on the data's device avoids a host round trip.
"""

from __future__ import annotations

from typing import Optional

import torch

_LN10 = 2.302585092994046


def db_to_amplitude(x: torch.Tensor) -> torch.Tensor:
    """``10 ** (0.5 * x)`` (reference dataset_utils.py:46-50)."""
    return torch.exp((0.5 * _LN10) * x)


def amplitude_to_db_scalar(x: torch.Tensor) -> torch.Tensor:
    """``20 * log10(x)`` (reference dataset_utils.py:39-43)."""
    return 20.0 * torch.log(x) / _LN10


def spectral_mix(stem_features: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Gain-weighted sum of stem spectrograms: ``[..., S, F, T]`` x ``[...,
    S]`` -> ``[..., F, T]`` (dB domain during training, reference quirk)."""
    return torch.einsum("...sft,...s->...ft", stem_features, gains)


def dummy_mix_db(stem_features_db: torch.Tensor, stem_axis: int = -3) -> torch.Tensor:
    """The DummyModel baseline: dB -> amplitude -> sum over stems -> dB
    (reference models/baselines/dummy_model.py:19-34)."""
    return amplitude_to_db_scalar(torch.sum(db_to_amplitude(stem_features_db), dim=stem_axis))


def _uniform(shape, generator: Optional[torch.Generator], like: torch.Tensor,
             gain_from: float, gain_to: float) -> torch.Tensor:
    device = like.device if generator is None else generator.device
    u = torch.rand(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return (gain_from + (gain_to - gain_from) * u).to(like.device)


def augment_features_db(features_db: torch.Tensor, generator: Optional[torch.Generator] = None,
                        gain_from: float = 0.6, gain_to: float = 1.4) -> torch.Tensor:
    """Per-stem random-gain augmentation in the dB feature domain:
    ``[..., num_stems, F, T]``, one linear gain per stem (and per leading
    batch element), converted to dB and added (reference
    data/dataset.py:170-179)."""
    gains = _uniform(features_db.shape[:-2], generator, features_db, gain_from, gain_to)
    return features_db + amplitude_to_db_scalar(gains)[..., None, None]


def augment_audio(audio: torch.Tensor, generator: Optional[torch.Generator] = None,
                  gain_from: float = 0.6, gain_to: float = 1.4, axis=None) -> torch.Tensor:
    """Waveform-domain random gain (reference data/dataset.py:164-168); one
    gain per leading batch element.  With ``axis`` (a ``MeshAxis`` whose
    ranks hold the global batch in rank order) the gains of the whole global
    batch are drawn and this rank takes its rows, so the ranks together draw
    what one process does on the global batch."""
    if axis is None or axis.size == 1:
        return audio * _uniform(audio.shape[:-1], generator, audio, gain_from, gain_to)[..., None]
    shape = (audio.shape[0] * axis.size, *audio.shape[1:-1])
    gains = _uniform(shape, generator, audio, gain_from, gain_to)[axis.rows(shape[0])]
    return audio * gains[..., None]


def stereo_to_mono(audio: torch.Tensor, channel_axis: int = -2) -> torch.Tensor:
    """Downmix by channel mean (reference data/dataset.py:181-183)."""
    return torch.mean(audio, dim=channel_axis)
