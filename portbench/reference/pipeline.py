"""The reference's whole path for one song or clip, through the family
that the configuration names: chunk features, the model's outputs, the
epilogue; and the comparison numbers that decide ``correct``.

Gains exist for chunks ``0 .. S // C - 2`` (deep-audio-mixer keeps no gain
for the last chunk); chunk ``i`` is samples ``[i C, (i + 1) C)``, framed on
its own.  Features and gains run on the given device in blocks of chunks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import epilogue, families, models


def precision(tf32: bool) -> None:
    """float32 convolutions and products in full float32 (TF32 off), or in
    TF32: the control's precision, the next below the configuration's."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def song_gains(weights: Dict[str, torch.Tensor], stems: np.ndarray, cfg: Dict,
               device, block: int = 16) -> np.ndarray:
    """``stems [stems, S]`` -> ``[n_gains, ...]`` the model's outputs
    (float32; ``[n_gains, stems]`` model scalars for the scalar heads)."""
    n_gains = stems.shape[-1] // cfg["chunk_samples"] - 1
    if n_gains <= 0:
        return np.zeros((0, stems.shape[0]), np.float32)
    features = families.of(cfg).features
    x = torch.as_tensor(np.asarray(stems, dtype=np.float32), device=device)
    out = []
    for lo in range(0, n_gains, block):
        n = min(block, n_gains - lo)
        out.append(models.gains(weights, features(x, lo, n, cfg), cfg))
    return torch.cat(out).cpu().numpy()


def song(weights, stems: np.ndarray, cfg: Dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """``(curves, mix)`` of the song ``stems [stems, S]``: what
    ``mix_song_smooth_device`` returns."""
    return families.of(cfg).song(weights, stems, cfg, device)


def clip(weights, stems: np.ndarray, cfg: Dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """``(raw, smoothed)`` gains of the clip ``stems [stems, S]``: what
    ``MixingService.gains`` returns."""
    return families.of(cfg).clip(weights, stems, cfg, device)


def mono_clip(weights, stems: np.ndarray, cfg: Dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """A family with one model scalar a stem and chunk: ``(raw amplitude
    gains, smoothed) [stems, n_gains]``."""
    num_chunks = stems.shape[-1] // cfg["chunk_samples"]
    raw = epilogue.amplitudes(song_gains(weights, stems, cfg, device))
    return raw, epilogue.smooth(raw, num_chunks, cfg["savgol_polyorder"])


def mono_song(weights, stems: np.ndarray, cfg: Dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """The same family's ``(smoothed curves [stems, n_gains],
    peak-normalised mono mix [S])``."""
    curves = mono_clip(weights, stems, cfg, device)[1]
    return curves, epilogue.mixdown(stems, curves)


def rel_err(got, ref) -> float:
    """Largest gap over each row's scale: ``max |got - ref| / max |ref|``,
    worst row; inf where the shapes differ or ``got`` is not finite."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    if not np.all(np.isfinite(got)):
        return float("inf")
    got2, ref2 = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    scale = np.maximum(np.abs(ref2).max(axis=-1), 1e-30)
    return float((np.abs(got2 - ref2).max(axis=-1) / scale).max())
