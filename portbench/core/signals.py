"""The general traffic generator: lengths and order of the songs or clips a
mix sends, and their stems, all from ``--seed``.

Lengths are fixed quantiles of the mix's distribution, the same set for
every seed; the seed only orders them, stratified so that every run of
``strata`` consecutive items holds one item of each stratum, and so every
window does nearly the same work.  Stems are made on the card in a few
large calls (``torch.Generator`` on the device) and then held in host
memory, where a user's decoded songs are: per stem band-limited noise and
tones under slow level envelopes (drums also under a beat), so the gains
move from chunk to chunk.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np
import torch


def seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit streams of one run seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(4, dtype=np.uint64)
    names = ("order", "audio", "weights", "sample")
    return {n: int(s) & ((1 << 63) - 1) for n, s in zip(names, state)}


def lengths_s(spec: Dict) -> List[float]:
    """The mix's item lengths in seconds, ascending: the midpoint quantiles
    ``(k + 0.5) / n`` of a log-normal (``median_s``, ``sigma``) or a uniform
    (``min_s``, ``max_s``) distribution, clipped to ``[min_s, max_s]``."""
    n = spec["quantiles"]
    qs = [(k + 0.5) / n for k in range(n)]
    if spec["distribution"] == "lognormal":
        z = NormalDist()
        vals = [spec["median_s"] * math.exp(spec["sigma"] * z.inv_cdf(q)) for q in qs]
    elif spec["distribution"] == "uniform":
        vals = [spec["min_s"] + q * (spec["max_s"] - spec["min_s"]) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['distribution']!r}")
    return [min(max(v, spec["min_s"]), spec["max_s"]) for v in vals]


def order(n: int, strata: int, seed: int) -> List[int]:
    """A seeded order of ``range(n)`` (indices into the ascending lengths)
    in which each block of ``strata`` items takes one from each stratum."""
    if n % strata:
        raise ValueError("quantiles must divide into the strata")
    rng = np.random.default_rng(seed)
    per = n // strata
    cols = [list(rng.permutation(range(s * per, (s + 1) * per))) for s in range(strata)]
    out: List[int] = []
    for r in range(per):
        block = [cols[s][r] for s in range(strata)]
        out += [block[i] for i in rng.permutation(strata)]
    return out


def stems(samples: int, spec: Dict, generator: torch.Generator, device) -> torch.Tensor:
    """``[stems, samples]`` float32 on ``device``."""
    sr = spec["sample_rate"]
    n = len(spec["stems"])
    g = generator
    t = torch.arange(samples, device=device, dtype=torch.float64) / sr
    noise = torch.randn((n, samples), generator=g, device=device)
    # zero-padded to a power of two: a transform of any other length may
    # need a slow plan
    nfft = 1 << (samples - 1).bit_length()
    spec_f = torch.fft.rfft(noise, n=nfft)
    freqs = torch.fft.rfftfreq(nfft, 1.0 / sr).to(device)
    out = []
    draws = torch.rand((n, 16), generator=g, device=device, dtype=torch.float64)
    for i, st in enumerate(spec["stems"]):
        lo, hi = st["band_hz"]
        band = torch.fft.irfft(spec_f[i] * ((freqs >= lo) & (freqs <= hi)), n=nfft)[:samples]
        band = band / band.square().mean().sqrt().clamp_min(1e-12)
        d = draws[i]
        tones = torch.zeros_like(t)
        for k in range(st["tones"]):
            f = lo + (hi - lo) * d[k]
            tones += torch.sin(2 * math.pi * f * t + 2 * math.pi * d[4 + k])
        tones = tones / math.sqrt(max(st["tones"], 1) / 2)
        level_db = st["level_db"] + sum(
            st["swing_db"] / 3 * torch.sin(2 * math.pi * t / (8.0 + 32.0 * d[8 + k])
                                           + 2 * math.pi * d[11 + k])
            for k in range(3))
        env = torch.pow(10.0, level_db / 20.0)
        if st.get("beat_s"):
            env = env * torch.exp(-torch.remainder(t, st["beat_s"]) / (0.1 * st["beat_s"]))
        mix = st["noise_share"] * band.to(torch.float64) + (1 - st["noise_share"]) * tones
        out.append((env * mix).to(torch.float32))
    return torch.stack(out)


def host_items(lengths: List[float], spec: Dict, seed: int, device) -> List[np.ndarray]:
    """Every distinct item's stems, made on ``device`` and held as host
    arrays ``[stems, samples]`` float32, in ascending length order."""
    g = torch.Generator(device=device).manual_seed(seed)
    sr = spec["sample_rate"]
    return [stems(int(round(s * sr)), spec, g, device).cpu().numpy() for s in lengths]
