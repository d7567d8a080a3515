"""Baseline mixing systems (tpumix/models/baselines.py; reference
models/baselines/).

* ``DummyModel`` — parameterless spectrogram-domain naive sum with dB<->amp
  round-trip (reference baselines/dummy_model.py:19-34).
* ``RandomModel`` — per-stem uniform random linear gain in [0.5, 1.5] applied
  to waveform dicts (baselines/random_model.py:4-14).  It draws from a numpy
  ``Generator``, so one seed gives the JAX package's gains.
* ``MeanLoudnessModel`` — loudness-normalise each stem to the train-set mean
  LUFS of its class (baselines/mean_loudness_model.py:4-20) with the host
  BS.1770 meter.

Random and MeanLoudness work on host-side waveform dicts, as in the
reference: they are evaluation-time comparators, not device programs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpumix_torch.ops.gain import dummy_mix_db
from tpumix_torch.ops.loudness import integrated_loudness, normalize_loudness

STEMS: Tuple[str, ...] = ("bass", "drums", "vocals", "other")


class DummyModel:
    """``forward(x [B, S, F, T] dB) -> [B, F, T]`` naive spectrogram sum."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return dummy_mix_db(x, stem_axis=-3)

    forward = __call__


class RandomModel:
    """Per-stem uniform random gain on waveform dicts."""

    def __init__(self, gain_from: float = 0.5, gain_to: float = 1.5,
                 rng: Optional[np.random.Generator] = None):
        self.tracklist = STEMS
        self._gain_from = gain_from
        self._gain_to = gain_to
        self._rng = rng or np.random.default_rng()

    def forward(self, x: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {
            track: float(self._rng.uniform(self._gain_from, self._gain_to)) * x[track]
            for track in self.tracklist
        }


class MeanLoudnessModel:
    """Normalise each stem to the train-set mean integrated loudness of its
    class.  ``mean_loudness`` maps stem name -> LUFS (from
    ``MultitrackAudioDataset.compute_mean_loudness``)."""

    def __init__(self, mean_loudness: Dict[str, float], sr: int = 44100):
        self.mean_loudness = mean_loudness
        self.sr = sr
        self.tracklist = STEMS

    def forward(self, x: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        result = {}
        for track in self.tracklist:
            # waveforms are [channels, samples]; the meter wants [samples, ch]
            audio = np.asarray(x[track])
            loud = integrated_loudness(audio.T, self.sr)
            if not np.isfinite(loud):
                # silent stem: -inf LUFS would imply an infinite gain; pass
                # silence through unchanged instead
                result[track] = audio
                continue
            result[track] = normalize_loudness(audio.T, loud, self.mean_loudness[track]).T
        return result
