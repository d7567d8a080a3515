"""Gain-curve smoothing and sample-level mask stretching (all of
tpumix/ops/smoothing.py).

* ``savgol_smooth`` — Savitzky-Golay with scipy ``mode='interp'`` semantics,
  built as a linear operator (FIR interior + least-squares polynomial edge
  fits); numpy on the host, ``savgol_smooth_torch`` on a device with a
  static window.
* ``interpolate_mask`` — nearest-neighbour stretch with integer
  ``coef = tgt_len // len`` and last-value tail fill (reference
  inference_utils.py:12-41).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def default_savgol_window(num_chunks: int) -> int:
    """Reference window policy: ``num_chunks // 4``, forced odd."""
    w = int(num_chunks) // 4
    return w if w % 2 else w + 1


@functools.lru_cache(maxsize=64)
def savgol_coeffs(window_length: int, polyorder: int) -> np.ndarray:
    """Central Savitzky-Golay FIR coefficients (float64, scipy parity)."""
    if window_length % 2 != 1:
        raise ValueError("window_length must be odd")
    half = window_length // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)
    return np.linalg.pinv(A)[0]


@functools.lru_cache(maxsize=64)
def _savgol_edge_matrix(window_length: int, polyorder: int) -> np.ndarray:
    """``E [half, window]``: the 'interp'-mode leading-edge values as a fit of
    the first ``window`` samples evaluated at positions ``0..half-1``."""
    half = window_length // 2
    x = np.arange(window_length, dtype=np.float64)
    A = np.vander(x, polyorder + 1, increasing=True)
    P = np.linalg.pinv(A)
    eval_pts = np.vander(np.arange(half, dtype=np.float64), polyorder + 1, increasing=True)
    return eval_pts @ P


def savgol_smooth(y: np.ndarray, window_length: int, polyorder: int = 2) -> np.ndarray:
    """Savitzky-Golay smoothing over the last axis (host, float64)."""
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[-1]
    if window_length > n:
        raise ValueError(f"window_length {window_length} exceeds signal length {n}")
    if polyorder >= window_length:
        raise ValueError("polyorder must be < window_length")
    c = savgol_coeffs(window_length, polyorder)
    interior = np.apply_along_axis(
        lambda row: np.convolve(row, c[::-1], mode="valid"), -1, y
    )
    E = _savgol_edge_matrix(window_length, polyorder)
    lead = np.einsum("hw,...w->...h", E, y[..., :window_length])
    tail = np.einsum("hw,...w->...h", E, y[..., ::-1][..., :window_length])[..., ::-1]
    return np.concatenate([lead, interior, tail], axis=-1)


def savgol_smooth_torch(y: torch.Tensor, window_length: int, polyorder: int = 2) -> torch.Tensor:
    """Device variant with a static window: ``y [rows, n]`` in its dtype."""
    c = torch.as_tensor(savgol_coeffs(window_length, polyorder), dtype=y.dtype, device=y.device)
    # conv1d is a correlation: correlating with c == convolving with c[::-1]
    interior = F.conv1d(y.reshape(-1, 1, y.shape[-1]), c.view(1, 1, -1)).reshape(
        *y.shape[:-1], -1
    )
    E = torch.as_tensor(_savgol_edge_matrix(window_length, polyorder), dtype=y.dtype,
                        device=y.device)
    lead = y[..., :window_length] @ E.T
    tail = (y.flip(-1)[..., :window_length] @ E.T).flip(-1)
    return torch.cat([lead, interior, tail], dim=-1)


def interpolate_mask_np(spec_mask: np.ndarray, tgt_len: int) -> np.ndarray:
    """Reference-exact nearest-neighbour stretch: value ``j`` fills
    ``[j*coef, (j+1)*coef)``; the last value also fills the tail."""
    spec_mask = np.asarray(spec_mask)
    n = spec_mask.shape[-1]
    if n > tgt_len:
        raise ValueError("Target mask should be longer than the initial one")
    coef = tgt_len // n
    body = np.repeat(spec_mask, coef, axis=-1)
    tail = tgt_len - n * coef
    if tail == 0:
        return body
    last = np.broadcast_to(spec_mask[..., -1:], spec_mask.shape[:-1] + (tail,))
    return np.concatenate([body, last], axis=-1)


def interpolate_mask(spec_mask: torch.Tensor, tgt_len: int) -> torch.Tensor:
    """Torch variant of :func:`interpolate_mask_np` (any leading dims)."""
    n = spec_mask.shape[-1]
    coef = tgt_len // n
    body = torch.repeat_interleave(spec_mask, coef, dim=-1)
    tail = tgt_len - n * coef
    if tail == 0:
        return body
    last = spec_mask[..., -1:].expand(*spec_mask.shape[:-1], tail)
    return torch.cat([body, last], dim=-1)
