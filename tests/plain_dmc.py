"""Plain reference of the Differentiable Mixing Console with the VGGish
encoder on a whole song of any number of mono 44.1 kHz tracks: plain
``torch`` and numpy, no kernel, cache or batching of the port, TF32 off.

Published description followed (Steinmetz et al., ICASSP 2021,
arXiv:2010.10291, csteinmetz1/automix-toolkit ``automix/models/dmc.py``;
Hershey et al., ICASSP 2017, tensorflow/models research/audioset/vggish
``vggish_input.py``, ``mel_features.py``, ``vggish_slim.py``):

* the whole track resampled to 16 kHz as ``resampy.resample(x, 44100,
  16000, filter="kaiser_best")`` computes it, output by output: output
  ``t`` at input time ``tau = 441 t / 160``, ``ceil(S * 160 / 441)``
  outputs, every input within 64 zero crossings of the downsampling filter
  (176.4 input samples) weighted by ``s h(s |tau - m|)``, ``s = 160 / 441``,
  samples outside the track zero;
* STFT magnitude over frames of 400 samples (periodic Hann), hop 160, no
  padding, FFT length 512; 64 HTK mel bands 125-7500 Hz, DC weight zeroed;
  ``log(mel + 0.01)``; examples of 96 frames, hop 96;
* VGGish: 3x3 SAME conv + bias + ReLU 64, pool, 128, pool, 256, 256, pool,
  512, 512, pool (2x2 max-pools, stride 2), NHWC flatten, fc 4096 + ReLU,
  fc 4096 + ReLU, fc 128;
* context: the mean embedding over the tracks of a chunk; post-processor
  on ``[e_t ; c]``: dense, PReLU, dense, PReLU, dense 2, sigmoid;
* console: ``gain_dB = -48 + 72 p0``, ``theta = p1 pi / 2``, ``a_L =
  10^(gain_dB/20) cos theta``, ``a_R = 10^(gain_dB/20) sin theta``; the
  stereo mix ``sum_t a_t x_t``.

Departures from it, each deliberate:

* the filter's taps are the closed form ``h(u) = r sinc(r u) I0(beta
  sqrt(1 - (u/64)^2)) / I0(beta)`` (``r = 0.9475937``, ``beta =
  14.769656``), not resampy's table of it interpolated at 2^9 points per
  zero crossing;
* the frontend is computed in float64 and its features rounded once to
  float32 (VGGish's numpy frontend is float64 too); the model is float32;
* one parameter set per 0.96 s chunk (42336 samples, the example of
  frames ``[96 k, 96 k + 96)``), for chunks ``0 .. S // 42336 - 2`` as
  every family of the port has them; the paper predicts one set per
  example of a training batch;
* the parameters are smoothed over the song before mixing, as the port
  does for every family: ``a_L`` and ``a_R`` of each track by
  Savitzky-Golay (window ``chunks // 4`` forced odd, capped by the curve,
  polyorder 2 bent to it, scipy ``mode="interp"``), stretched to samples
  (nearest neighbour, the last value filling the tail); the mix is
  peak-normalised;
* the post-processor's widths (256) and the gain range (-48..24 dB) are
  assumed: the paper gives neither.

Names of the weights are the port's ``state_dict`` names.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from numpy.lib.stride_tricks import as_strided
import torch.nn.functional as F

SR_IN, SR = 44100, 16000
CHUNK = 42336
NUM_ZEROS, ROLLOFF, BETA = 64, 0.9475937, 14.769656
WINDOW, HOP, N_FFT, BANDS = 400, 160, 512, 64
CONVS = (("conv1", True), ("conv2", True), ("conv3_1", False), ("conv3_2", True),
         ("conv4_1", False), ("conv4_2", True))


def _precision_full() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resample(x: np.ndarray) -> np.ndarray:
    """``[tracks, S]`` at 44.1 kHz -> ``[tracks, ceil(S * 160 / 441)]`` at
    16 kHz, float64.  Output ``t`` reads the inputs ``floor(tau) + k`` for
    ``|k| <= 177``; the fraction of ``tau`` repeats every 160 outputs, so the
    outputs ``t = p mod 160`` share one weight vector, applied to every
    441-sample step of the zero-padded track."""
    x = np.asarray(x, dtype=np.float64)
    S = x.shape[-1]
    n_out = -(-S * SR // SR_IN)
    s = SR / SR_IN
    reach = NUM_ZEROS / s
    offsets = np.arange(-math.ceil(reach), math.ceil(reach) + 1)
    taps = len(offsets)

    def floor_tau(t):
        return (t * SR_IN) // SR  # exact integer floor of tau = 441 t / 160

    t0 = np.arange(160)
    u = s * np.abs((t0 * (SR_IN / SR))[:, None] - (floor_tau(t0)[:, None] + offsets))
    ratio = np.minimum(u / NUM_ZEROS, 1.0)
    h = ROLLOFF * np.sinc(ROLLOFF * u) * np.i0(BETA * np.sqrt(1.0 - ratio ** 2)) / np.i0(BETA)
    w0 = np.where(u <= NUM_ZEROS, s * h, 0.0)  # [160, taps]
    lead = -offsets[0]
    padded = np.zeros((x.shape[0], S + 2 * taps + SR_IN // 100))
    padded[:, lead:lead + S] = x
    out = np.empty((x.shape[0], n_out))
    for p in range(160):
        count = len(range(p, n_out, 160))
        first = floor_tau(p) + offsets[0] + lead
        reads = as_strided(padded[:, first:], shape=(x.shape[0], count, taps),
                           strides=(padded.strides[0], 441 * 8, 8), writeable=False)
        out[:, p::160] = reads @ w0[p]
    return out


def mel_weights() -> np.ndarray:
    def mel(hz):
        return 1127.0 * np.log(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)

    bins = mel(np.linspace(0.0, SR / 2, N_FFT // 2 + 1))
    edges = np.linspace(mel(125.0), mel(7500.0), BANDS + 2)
    w = np.empty((N_FFT // 2 + 1, BANDS))
    for i in range(BANDS):
        lo, c, hi = edges[i:i + 3]
        w[:, i] = np.maximum(0.0, np.minimum((bins - lo) / (c - lo), (hi - bins) / (hi - c)))
    w[0, :] = 0.0
    return w


def examples(x: np.ndarray) -> torch.Tensor:
    """Every VGGish example of the song ``x [tracks, S]``: ``[examples,
    tracks, 96, 64]`` float32."""
    y = resample(x)
    frames = 1 + (y.shape[-1] - WINDOW) // HOP
    idx = np.arange(frames)[:, None] * HOP + np.arange(WINDOW)[None, :]
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(WINDOW) / WINDOW)
    mag = np.abs(np.fft.rfft(y[:, idx] * hann, N_FFT))
    logmel = np.log(mag @ mel_weights() + 0.01)  # [tracks, frames, 64]
    n = 1 + (frames - 96) // 96
    ex = logmel[:, :n * 96].reshape(x.shape[0], n, 96, BANDS).transpose(1, 0, 2, 3)
    return torch.as_tensor(np.ascontiguousarray(ex), dtype=torch.float32)


def encoder(w: Dict[str, torch.Tensor], ex: torch.Tensor) -> torch.Tensor:
    """``[B, 96, 64]`` -> ``[B, 128]``."""
    h = ex[:, None]
    for name, pool in CONVS:
        h = torch.relu(F.conv2d(h, w[f"encoder.{name}.weight"], w[f"encoder.{name}.bias"],
                                padding=1))
        if pool:
            h = F.max_pool2d(h, 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(F.linear(h, w["encoder.fc1_1.weight"], w["encoder.fc1_1.bias"]))
    h = torch.relu(F.linear(h, w["encoder.fc1_2.weight"], w["encoder.fc1_2.bias"]))
    return F.linear(h, w["encoder.fc2.weight"], w["encoder.fc2.bias"])


def logits(w: Dict[str, torch.Tensor], ex: torch.Tensor) -> torch.Tensor:
    """``[chunks, tracks, 96, 64]`` -> the post-processor's ``[chunks,
    tracks, 2]`` pre-sigmoid outputs."""
    n, tracks = ex.shape[:2]
    e = encoder(w, ex.reshape(n * tracks, 96, 64)).reshape(n, tracks, -1)
    h = torch.cat([e, e.mean(dim=1, keepdim=True).expand_as(e)], dim=-1)
    for i in (1, 2):
        h = F.linear(h, w[f"post.dense{i}.weight"], w[f"post.dense{i}.bias"])
        h = F.prelu(h, w[f"post.act{i}.weight"])
    return F.linear(h, w["post.dense3.weight"], w["post.dense3.bias"])


def console(p: torch.Tensor) -> torch.Tensor:
    gain = 10.0 ** ((-48.0 + 72.0 * p[..., 0]) / 20.0)
    theta = p[..., 1] * (math.pi / 2)
    return torch.stack([gain * torch.cos(theta), gain * torch.sin(theta)], dim=-1)


def amplitudes(w: Dict[str, torch.Tensor], ex: torch.Tensor) -> torch.Tensor:
    """``[chunks, tracks, 96, 64]`` examples -> ``(a_L, a_R)`` ``[chunks,
    tracks, 2]``."""
    _precision_full()
    with torch.no_grad():
        return console(torch.sigmoid(logits(w, ex)))


def chunk_amplitudes(w: Dict[str, torch.Tensor], x: np.ndarray) -> torch.Tensor:
    """``(a_L, a_R)`` of every chunk with a gain: ``[S // C - 1, tracks, 2]``."""
    return amplitudes(w, examples(x)[:x.shape[-1] // CHUNK - 1])


def calibrate(w: Dict[str, torch.Tensor], ex: torch.Tensor) -> None:
    """Scale the last dense layer in place so that both logits have zero
    mean and unit standard deviation over ``ex``'s chunks and tracks."""
    with torch.no_grad():
        z = logits(w, ex).reshape(-1, 2)
        mean, std = z.mean(dim=0), z.std(dim=0, unbiased=False)
        w["post.dense3.weight"].div_(std[:, None])
        w["post.dense3.bias"].sub_(mean).div_(std)


def smooth(curves: np.ndarray, num_chunks: int) -> np.ndarray:
    n = curves.shape[-1]
    if n < 3:
        return curves.copy()
    from scipy.signal import savgol_filter

    win = num_chunks // 4
    win = win if win % 2 else win + 1
    win = max(min(win, n if n % 2 else n - 1), 1)
    return savgol_filter(curves, win, min(2, win - 1), axis=-1, mode="interp")


def stretch(curves: np.ndarray, length: int) -> np.ndarray:
    n = curves.shape[-1]
    out = np.repeat(curves, length // n, axis=-1)
    tail = length - out.shape[-1]
    return np.concatenate([out, np.repeat(curves[..., -1:], tail, axis=-1)], axis=-1)


def song(w: Dict[str, torch.Tensor], x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(curves [tracks, 2, S // C - 1], mix [2, S])``: the smoothed
    ``(a_L, a_R)`` and the peak-normalised stereo mix, float64."""
    x = np.asarray(x, dtype=np.float64)
    tracks, S = x.shape
    amps = chunk_amplitudes(w, x).double().numpy()  # [n, tracks, 2]
    curves = smooth(amps.transpose(1, 2, 0), S // CHUNK)
    mix = (x[:, None, :] * stretch(curves, S)).sum(axis=0)
    peak = np.abs(mix).max()
    return curves, mix / peak if peak > 0 else mix
