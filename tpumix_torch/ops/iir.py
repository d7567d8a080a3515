"""Biquad (IIR) filtering as FIR / FFT convolution (tpumix/ops/iir.py).

A biquad cascade is a sequential recurrence.  The K-weighting filters of the
loudness meter (``ops/loudness.py``) are stable, with impulse responses that
decay below 1e-7 within a few thousand samples, so the device meter applies
them as one convolution:

1. the cascade's impulse response is materialised once on the host (exact
   float64 recurrence over ``fir_len`` samples; a copy of the JAX package's
   host code), and
2. applied on the tensor's device as zero-padded FFT convolution
   (``torch.fft``; overlap-save across blocks for long signals), with no
   per-sample dependency chain.

Truncation error is controlled by ``fir_len`` (default 16384: |h| tail
< 1e-9 for the BS.1770 filters at 44.1/48 kHz).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _impulse_response_np(
    sections: Tuple[Tuple[Tuple[float, ...], Tuple[float, ...]], ...], fir_len: int
) -> np.ndarray:
    """Exact float64 impulse response of a biquad cascade (host-side)."""
    h = np.zeros(fir_len, dtype=np.float64)
    h[0] = 1.0
    for b, a in sections:
        b = np.asarray(b, dtype=np.float64)
        a = np.asarray(a, dtype=np.float64)
        y = np.zeros_like(h)
        y1 = y2 = 0.0
        x1 = x2 = 0.0
        for n in range(fir_len):
            yn = b[0] * h[n] + b[1] * x1 + b[2] * x2 - a[1] * y1 - a[2] * y2
            x2, x1 = x1, h[n]
            y2, y1 = y1, yn
            y[n] = yn
        h = y
    return h


@functools.lru_cache(maxsize=16)
def _cached_fir(key: Tuple, fir_len: int) -> np.ndarray:
    return _impulse_response_np(key, fir_len)


def _hashable(sections: Sequence[Tuple[np.ndarray, np.ndarray]]) -> Tuple:
    return tuple((tuple(float(v) for v in b), tuple(float(v) for v in a)) for b, a in sections)


def fir_from_biquads(
    sections: Sequence[Tuple[np.ndarray, np.ndarray]], fir_len: int = 16384
) -> np.ndarray:
    """Truncated impulse response of a cascade of (b, a) biquads."""
    return _cached_fir(_hashable(sections), fir_len)


def fft_filter(x: torch.Tensor, h: torch.Tensor, block: int = 1 << 18) -> torch.Tensor:
    """Causal FIR filtering along the last axis by FFT convolution; returns
    the same length as ``x`` (lfilter semantics: zero initial conditions, no
    tail).

    One FFT over the whole signal when ``len(x) + len(h) <= block``; else
    overlap-save: segments of ``block`` samples, each carrying ``len(h) - 1``
    samples of left context, so segments are independent."""
    m = h.shape[-1]
    n = x.shape[-1]
    if n + m <= block:
        nfft = 1
        while nfft < n + m:
            nfft <<= 1
        y = torch.fft.irfft(torch.fft.rfft(x, n=nfft) * torch.fft.rfft(h, n=nfft), n=nfft)
        return y[..., :n].to(x.dtype)

    step = block - (m - 1)
    num_blocks = -(-n // step)
    xp = F.pad(x, (m - 1, num_blocks * step - n))
    segs = xp.unfold(-1, block, step)  # [..., num_blocks, block] overlapping view
    Y = torch.fft.irfft(torch.fft.rfft(segs, n=block) * torch.fft.rfft(h, n=block), n=block)
    out = Y[..., m - 1:].reshape(*Y.shape[:-2], num_blocks * step)
    return out[..., :n].to(x.dtype)


def biquad(x: torch.Tensor, b: Sequence[float], a: Sequence[float],
           fir_len: int = 16384) -> torch.Tensor:
    """Apply one biquad along the last axis (zero initial conditions,
    scipy.signal.lfilter parity up to FIR truncation)."""
    return biquad_cascade(x, [(np.asarray(b), np.asarray(a))], fir_len)


def biquad_cascade(x: torch.Tensor, sections: Sequence[Tuple[np.ndarray, np.ndarray]],
                   fir_len: int = 16384) -> torch.Tensor:
    """Apply a cascade of (b, a) biquads along the last axis in one pass: the
    sections are folded into a single impulse response, so the device does
    one FFT convolution whatever the cascade's depth."""
    h = torch.as_tensor(fir_from_biquads(sections, fir_len), dtype=torch.float32,
                        device=x.device)
    return fft_filter(x, h)
