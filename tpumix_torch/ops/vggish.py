"""The VGGish frontend on 44.1 kHz tracks: resampling to 16 kHz, STFT
magnitude, 64 mel bands and ``log(mel + 0.01)``, grouped into 0.96 s
examples of ``[96, 64]`` (tensorflow/models research/audioset/vggish:
``vggish_input.waveform_to_examples``, ``mel_features.py``).

* Resampling (``resampy.resample(x, 44100, 16000)`` with ``kaiser_best``):
  output sample ``t`` sits at input time ``tau = t * 441 / 160`` and is
  ``sum_m x[m] * s * h(s * |tau - m|)`` with ``s = 160 / 441`` and the
  windowed sinc ``h(u) = r * sinc(r * u) * I0(beta * sqrt(1 - (u / 64)^2)) /
  I0(beta)`` for ``u <= 64`` zero crossings (roll-off ``r = 0.9475937``,
  Kaiser ``beta = 14.769656``); samples outside the song are zero.  The taps
  are the closed form, not resampy's table interpolated at 2^9 points per
  zero crossing.  Since ``tau`` repeats its fraction every 160 outputs
  (441 inputs), the resampler is one product of each 441-sample step's
  window of ``TAPS`` inputs with a ``[160, TAPS]`` table.
* Frames of 400 samples (periodic Hann), hop 160, no padding, each
  zero-padded to a 512-point FFT; magnitude; HTK mel bands 125-7500 Hz
  with the DC bin's weight zeroed; ``log(mel + 0.01)``.

A chunk is 0.96 s: ``CHUNK = 42336`` samples at 44.1 kHz, 15360 at 16 kHz,
and example ``k`` of a song is its frames ``[96 k, 96 k + 96)``.  The last
frame of chunk ``k`` ends 240 samples (at 16 kHz) into chunk ``k + 1``, and
each resampled sample reads up to 176.4 input samples either side, so a
segment of chunks is computed from its slice of the song widened by
``HALO = (HALO_LEFT, HALO_RIGHT)`` input samples (zeros past the song's
ends; ``SongMixer.segment_input`` cuts it), and the features of a segment
then equal those of the whole song.  Everything is float32 torch
operations, on any device.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

SAMPLE_RATE_IN = 44100
SAMPLE_RATE = 16000
UP, DOWN = 160, 441  # 16000 / 44100 in lowest terms
NUM_ZEROS = 64
ROLLOFF = 0.9475937
KAISER_BETA = 14.769656

WINDOW = 400  # 25 ms at 16 kHz
HOP = 160  # 10 ms
N_FFT = 512
MEL_BANDS = 64
MEL_LOW_HZ, MEL_HIGH_HZ = 125.0, 7500.0
LOG_OFFSET = 0.01
EXAMPLE_FRAMES = 96  # 0.96 s

CHUNK = DOWN * EXAMPLE_FRAMES  # 42336 input samples = 96 hops of 160 at 16 kHz

_SCALE = UP / DOWN
_REACH = NUM_ZEROS / _SCALE  # 176.4 input samples either side of an output
HALO_LEFT = math.ceil(_REACH)  # inputs before the first output's time
#: inputs each 441-step window reads: from HALO_LEFT before the step to the
#: last phase's reach after it
TAPS = HALO_LEFT + math.floor((UP - 1) * DOWN / UP + _REACH) + 1
#: resampler steps a chunk's frames need: 96 of its own and two more for the
#: 240 samples its last frame reads of the next chunk
_STEPS_PAST = -(-(WINDOW - HOP) // UP)
HALO_RIGHT = (_STEPS_PAST - 1) * DOWN + TAPS - HALO_LEFT
HALO: Tuple[int, int] = (HALO_LEFT, HALO_RIGHT)


def kaiser_sinc(u: np.ndarray) -> np.ndarray:
    """``h(u)``, resampy's ``kaiser_best`` filter at ``u`` zero crossings
    (float64, zero past ``NUM_ZEROS``)."""
    u = np.abs(np.asarray(u, dtype=np.float64))
    inside = u <= NUM_ZEROS
    ratio = np.where(inside, u / NUM_ZEROS, 1.0)
    taper = np.i0(KAISER_BETA * np.sqrt(1.0 - ratio * ratio)) / np.i0(KAISER_BETA)
    return np.where(inside, ROLLOFF * np.sinc(ROLLOFF * u) * taper, 0.0)


@functools.lru_cache(maxsize=1)
def resample_table() -> np.ndarray:
    """``[UP, TAPS]`` float64: the weight of input ``DOWN q - HALO_LEFT + j``
    in output ``UP q + p``."""
    p = np.arange(UP, dtype=np.float64)[:, None]
    j = np.arange(TAPS, dtype=np.float64)[None, :]
    d = p * DOWN / UP - (j - HALO_LEFT)  # output time less input time, in inputs
    return _SCALE * kaiser_sinc(_SCALE * d)


def hertz_to_mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=1)
def mel_matrix() -> np.ndarray:
    """``[N_FFT // 2 + 1, MEL_BANDS]`` float64 triangular HTK weights, DC
    row zeroed (``mel_features.spectrogram_to_mel_matrix``)."""
    bins = N_FFT // 2 + 1
    bins_mel = hertz_to_mel(np.linspace(0.0, SAMPLE_RATE / 2.0, bins))
    edges = np.linspace(hertz_to_mel(MEL_LOW_HZ), hertz_to_mel(MEL_HIGH_HZ), MEL_BANDS + 2)
    lower, center, upper = edges[:-2], edges[1:-1], edges[2:]
    up = (bins_mel[:, None] - lower) / (center - lower)
    down = (upper - bins_mel[:, None]) / (upper - center)
    w = np.maximum(0.0, np.minimum(up, down))
    w[0, :] = 0.0
    return w


def periodic_hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The resampling table (transposed), the window and the mel matrix as
    float32 tensors on ``device``."""
    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)

    return f32(resample_table().T), f32(periodic_hann(WINDOW)), f32(mel_matrix())


def resample(x: torch.Tensor) -> torch.Tensor:
    """``x [..., L]``, input samples from ``DOWN q0 - HALO_LEFT`` on ->
    ``[..., UP Q]``, the 16 kHz samples from ``UP q0`` on, for the ``Q =
    (L - TAPS) // DOWN + 1`` steps whose windows ``x`` holds whole."""
    table_t, _, _ = _constants(x.device)
    steps = x.unfold(-1, TAPS, DOWN)  # [..., Q, TAPS]
    y = steps @ table_t  # [..., Q, UP]
    return y.reshape(*x.shape[:-1], -1)


def log_mel(y: torch.Tensor, frames: int) -> torch.Tensor:
    """The first ``frames`` log-mel frames of 16 kHz ``y [..., L]`` ->
    ``[..., frames, MEL_BANDS]``."""
    _, window, mel = _constants(y.device)
    need = (frames - 1) * HOP + WINDOW
    if y.shape[-1] < need:
        raise ValueError(f"{frames} frames need {need} samples, got {y.shape[-1]}")
    framed = y[..., :need].unfold(-1, WINDOW, HOP) * window  # [..., frames, WINDOW]
    mag = torch.fft.rfft(framed, n=N_FFT).abs()
    return torch.log(mag @ mel + LOG_OFFSET)


def segment_examples(x: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """``x [tracks, HALO_LEFT + n_chunks * CHUNK + HALO_RIGHT]``, chunks
    ``[lo, lo + n_chunks)`` of each track with their halo (zeros beyond the
    song) -> ``[n_chunks, tracks, 96, 64]`` examples."""
    want = HALO_LEFT + n_chunks * CHUNK + HALO_RIGHT
    if x.dim() != 2 or x.shape[-1] != want:
        raise ValueError(f"a {n_chunks}-chunk segment is [tracks, {want}], got {tuple(x.shape)}")
    frames = n_chunks * EXAMPLE_FRAMES
    feats = log_mel(resample(x.to(torch.float32)), frames)  # [tracks, frames, 64]
    return feats.reshape(x.shape[0], n_chunks, EXAMPLE_FRAMES, MEL_BANDS).transpose(0, 1)
