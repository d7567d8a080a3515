"""ITU-R BS.1770-4 loudness metering and loudness normalisation
(tpumix/ops/loudness.py).

* K-weighting pre-filter: stage-1 high-shelf (+4 dB, fc=1681.97 Hz,
  Q=0.7071752) and stage-2 high-pass (fc=38.135 Hz, Q=0.5003270), RBJ biquad
  coefficient formulas evaluated for the actual sample rate (the same
  parametrisation pyloudnorm uses, so meters agree across sample rates).
* Gated integrated loudness: 400 ms blocks with 75 % overlap, per-channel mean
  square, channel weights (1, 1, 1, 1.41, 1.41), absolute gate at -70 LKFS and
  relative gate at -10 LU below the absolute-gated mean
  (BS.1770-4 Annex 1).

The host meter (``integrated_loudness``, ``Meter``, ``normalize_loudness``;
numpy and scipy ``lfilter``, float64) is a copy of the JAX package's, which the
port does not import.  The device meter (``integrated_loudness_torch``,
``block_loudness_torch``) runs on the input tensor's device: the K-weighting
as one FFT convolution (``ops/iir.py``), block energies from a cumulative
sum, both gates as masked means, batched over leading axes.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import lfilter

from tpumix_torch.ops.iir import biquad_cascade


def _high_shelf_coeffs(fs: float, gain_db: float = 3.999843853973347,
                       fc: float = 1681.9744509555319,
                       q: float = 0.7071752369554196) -> Tuple[np.ndarray, np.ndarray]:
    """BS.1770 stage-1 high-shelf, De Man tan-domain parametrisation — the
    (G, fc, Q) triple reverse-engineered so that at fs=48000 these reproduce
    the coefficients published in BS.1770-4 Table 1 exactly, and generalise
    consistently to other sample rates."""
    K = math.tan(math.pi * fc / fs)
    Vh = 10.0 ** (gain_db / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / q + K * K
    b = np.array([
        (Vh + Vb * K / q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / q + K * K) / a0,
    ])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / q + K * K) / a0])
    return b, a


def _high_pass_coeffs(fs: float, fc: float = 38.13547087602444,
                      q: float = 0.5003270373238773) -> Tuple[np.ndarray, np.ndarray]:
    """BS.1770 stage-2 RLB high-pass (De Man parametrisation; note the
    standard's numerator is the un-normalised [1, -2, 1], matching Table 2)."""
    K = math.tan(math.pi * fc / fs)
    denom = 1.0 + K / q + K * K
    b = np.array([1.0, -2.0, 1.0])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / denom, (1.0 - K / q + K * K) / denom])
    return b, a


@functools.lru_cache(maxsize=8)
def k_weighting_coeffs(fs: float):
    return _high_shelf_coeffs(fs), _high_pass_coeffs(fs)


def k_weight(audio: np.ndarray, fs: float) -> np.ndarray:
    """Apply the two-stage K-weighting filter along axis 0 (samples)."""
    (b1, a1), (b2, a2) = k_weighting_coeffs(fs)
    y = lfilter(b1, a1, audio, axis=0)
    return lfilter(b2, a2, y, axis=0)


# BS.1770 channel weights: L, R, C, Ls, Rs
_CHANNEL_G = np.array([1.0, 1.0, 1.0, 1.41, 1.41])
_ABS_GATE_LUFS = -70.0
_REL_GATE_LU = -10.0
_BLOCK_S = 0.400
_OVERLAP = 0.75


def integrated_loudness(audio: np.ndarray, fs: float) -> float:
    """Gated integrated loudness in LUFS.

    :param audio: ``[samples]`` mono or ``[samples, channels]`` (pyloudnorm
        convention — the reference passes ``track.T`` of ``[ch, samples]``
        arrays, evaluation.py:40).
    """
    audio = np.asarray(audio, dtype=np.float64)
    if audio.ndim == 1:
        audio = audio[:, None]
    n_samples, n_ch = audio.shape
    if n_ch > 5:
        raise ValueError(f"at most 5 channels supported, got {n_ch}")

    block = int(round(_BLOCK_S * fs))
    step = int(round(block * (1.0 - _OVERLAP)))
    if n_samples < block:
        return -np.inf

    y = k_weight(audio, fs)
    n_blocks = (n_samples - block) // step + 1
    # mean square per (block, channel) via cumulative sums — O(n) not O(n*block)
    csum = np.concatenate([np.zeros((1, n_ch)), np.cumsum(y * y, axis=0)], axis=0)
    starts = np.arange(n_blocks) * step
    z = (csum[starts + block] - csum[starts]) / block  # [n_blocks, n_ch]

    g = _CHANNEL_G[:n_ch]
    with np.errstate(divide="ignore"):
        l_blocks = -0.691 + 10.0 * np.log10(np.maximum(z @ g, 1e-30))

    above_abs = l_blocks > _ABS_GATE_LUFS
    if not np.any(above_abs):
        return -np.inf
    z_abs = z[above_abs].mean(axis=0)
    rel_gate = -0.691 + 10.0 * np.log10(max(z_abs @ g, 1e-30)) + _REL_GATE_LU

    gated = above_abs & (l_blocks > rel_gate)
    if not np.any(gated):
        return -np.inf
    z_gated = z[gated].mean(axis=0)
    return float(-0.691 + 10.0 * np.log10(max(z_gated @ g, 1e-30)))


def normalize_loudness(audio: np.ndarray, input_loudness: float, target_loudness: float) -> np.ndarray:
    """Gain-scale ``audio`` from ``input_loudness`` to ``target_loudness`` LUFS
    (pyloudnorm.normalize.loudness parity — pure gain, no limiting)."""
    delta = target_loudness - input_loudness
    return audio * (10.0 ** (delta / 20.0))


class Meter:
    """pyloudnorm.Meter API shim (reference evaluation.py:32)."""

    def __init__(self, rate: float):
        self.rate = rate

    def integrated_loudness(self, audio: np.ndarray) -> float:
        return integrated_loudness(audio, self.rate)


def _block_energies(y: torch.Tensor, fs: float, block_s: float = _BLOCK_S,
                    overlap: float = _OVERLAP) -> Tuple[torch.Tensor, int]:
    """Mean square of every 400 ms block (75 % overlap) of K-weighted
    ``y [..., S]`` -> ``[..., n_blocks]``, as differences of one cumulative
    sum."""
    block = int(round(block_s * fs))
    step = int(round(block * (1.0 - overlap)))
    n_blocks = max((y.shape[-1] - block) // step + 1, 0)
    csum = F.pad(torch.cumsum(y * y, dim=-1), (1, 0))
    starts = torch.arange(n_blocks, device=y.device) * step
    return (csum[..., starts + block] - csum[..., starts]) / block


def integrated_loudness_torch(audio: torch.Tensor, fs: float) -> torch.Tensor:
    """Gated integrated loudness (LUFS) on the input's device, batched
    (tpumix/ops/loudness.py ``integrated_loudness_jax``).

    :param audio: ``[..., channels, samples]`` with ``channels <= 5``; a 1-D
        tensor is read as ``[1, samples]`` mono.  A 2-D input is always
        ``[channels, samples]``: a batch of mono songs is ``[batch, 1,
        samples]``.
    :return: ``[...]`` LUFS values, ``-inf`` for all-gated (silent) signals.

    Same algorithm as :func:`integrated_loudness`, in float32: the K-weighting
    as one FFT convolution, block energies from a cumulative sum, both gates
    as masked means (no data-dependent shapes)."""
    x = torch.as_tensor(audio).to(torch.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.shape[-2] > 5:
        raise ValueError("expected [..., channels<=5, samples]")

    if x.shape[-1] < int(round(_BLOCK_S * fs)):
        raise ValueError("signal shorter than one 400 ms block")
    y = biquad_cascade(x, list(k_weighting_coeffs(fs)))
    z = _block_energies(y, fs)  # [..., ch, blocks]
    g = torch.as_tensor(_CHANNEL_G[: z.shape[-2]], dtype=torch.float32, device=z.device)
    power = torch.einsum("...cb,c->...b", z, g)  # [..., blocks]
    l_blocks = -0.691 + 10.0 * torch.log10(power.clamp_min(1e-30))

    abs_mask = (l_blocks > _ABS_GATE_LUFS).to(torch.float32)
    z_abs = (power * abs_mask).sum(-1) / abs_mask.sum(-1).clamp_min(1.0)
    rel_gate = -0.691 + 10.0 * torch.log10(z_abs.clamp_min(1e-30)) + _REL_GATE_LU

    gated = abs_mask * (l_blocks > rel_gate[..., None]).to(torch.float32)
    z_gated = (power * gated).sum(-1) / gated.sum(-1).clamp_min(1.0)
    lufs = -0.691 + 10.0 * torch.log10(z_gated.clamp_min(1e-30))
    return torch.where(gated.sum(-1) > 0, lufs, torch.full_like(lufs, -math.inf))


def block_loudness_torch(audio: torch.Tensor, fs: float, block_s: float = _BLOCK_S,
                         overlap: float = _OVERLAP) -> torch.Tensor:
    """Momentary block loudness (no gating) on the input's device: per-block
    LKFS of mono ``[..., samples]`` signals (tpumix/ops/loudness.py
    ``block_loudness_jax``)."""
    y = biquad_cascade(torch.as_tensor(audio), list(k_weighting_coeffs(fs)))
    z = _block_energies(y, fs, block_s, overlap)
    return -0.691 + 10.0 * torch.log10(z.clamp_min(1e-30))
