"""Plain mixing epilogue in float64 (deep-audio-mixer inference_utils.py
``mix_song_smooth``): model scalars -> amplitudes ``10**(0.5 g)`` ->
Savitzky-Golay (scipy, ``mode='interp'``) with window ``num_chunks // 4``
forced odd, capped by the curve's length, polyorder 2 bent to the window
-> nearest-neighbour stretch to sample level with the last value filling the
tail -> per-stem scaling -> mixdown -> peak normalisation."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def window(num_chunks: int, n_gains: int, polyorder: int = 2) -> Tuple[int, int]:
    w = num_chunks // 4
    w = w if w % 2 else w + 1
    w = max(min(w, n_gains if n_gains % 2 else n_gains - 1), 1)
    return w, min(polyorder, w - 1)


def amplitudes(gains: np.ndarray) -> np.ndarray:
    """``[n_gains, stems]`` model scalars -> ``[stems, n_gains]`` float64."""
    return 10.0 ** (0.5 * np.asarray(gains, dtype=np.float64).T)


def smooth(curves: np.ndarray, num_chunks: int, polyorder: int = 2) -> np.ndarray:
    n = curves.shape[-1]
    if n < 3:
        return curves.copy()
    from scipy.signal import savgol_filter  # imported after the window: scipy is slow to load

    w, p = window(num_chunks, n, polyorder)
    return savgol_filter(curves, w, p, axis=-1, mode="interp")


def stretch(curves: np.ndarray, length: int) -> np.ndarray:
    n = curves.shape[-1]
    coef = length // n
    out = np.repeat(curves, coef, axis=-1)
    if out.shape[-1] < length:
        tail = np.repeat(curves[..., -1:], length - out.shape[-1], axis=-1)
        out = np.concatenate([out, tail], axis=-1)
    return out


def mixdown(stems: np.ndarray, smoothed: np.ndarray) -> np.ndarray:
    """``stems [stems, S]`` scaled by the stretched curves, summed, divided
    by the peak: the mix ``[S]`` in float64."""
    mixed = (np.asarray(stems, dtype=np.float64) * stretch(smoothed, stems.shape[-1])).sum(0)
    peak = np.abs(mixed).max()
    return mixed / peak if peak > 0 else mixed
