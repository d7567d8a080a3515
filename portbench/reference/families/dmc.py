"""The dmc family: the Differentiable Mixing Console (Steinmetz, Pons,
Pascual and Serra, ICASSP 2021, arXiv:2010.10291; csteinmetz1/automix-toolkit
``automix/models/dmc.py``) with the VGGish encoder (Hershey et al., ICASSP
2017; tensorflow/models research/audioset/vggish), on a session of any
number of mono 44.1 kHz tracks.

* Features, per track, over the whole track: resampled to 16 kHz as
  ``resampy.resample(x, 44100, 16000)`` with ``kaiser_best`` (output ``t``
  at input time ``441 t / 160``, every input within 64 zero crossings of the
  filter, zeros outside the track), with the filter's closed form taps and
  not resampy's interpolated table; frames of 400 (periodic Hann), hop 160,
  FFT 512, magnitude; 64 HTK mel bands 125-7500 Hz, DC weight zeroed;
  ``log(mel + 0.01)``; example ``k`` is frames ``[96 k, 96 k + 96)``, the
  chunk ``[42336 k, 42336 (k + 1))``.  Computed in float64 on the device,
  rounded once to float32.
* Model, float32: VGGish (3x3 SAME conv + bias + ReLU blocks with 2x2
  max-pools, NHWC flatten, fc 4096, 4096 with ReLU, fc 128), the mean
  embedding of the chunk's tracks as context, the post-processor on ``[e_t ;
  c]`` (dense, PReLU, dense, PReLU, dense 2, sigmoid) and the console:
  ``gain_dB = -48 + 72 p0``, ``theta = p1 pi / 2``, ``(a_L, a_R) =
  10^(gain_dB / 20) (cos theta, sin theta)``.
* Epilogue, float64: ``a_L`` and ``a_R`` of every track smoothed as the
  other families' curves (``epilogue.smooth``), stretched to samples, each
  track scaled into both channels, summed, peak-normalised.

Weights: He-normal for the layers a ReLU follows, lecun-normal for the
others, PReLU slopes 0.25; ``forward(..., calibrate=True)`` scales the last
dense layer in place (its weight and its bias) so that both logits have
zero mean and unit standard deviation over the batch's chunks and tracks,
and the curves move with the audio.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import epilogue

#: chunks of examples run through the model at once
BLOCK = 16


def _he(x: torch.Tensor, shape, wcfg: Dict) -> torch.Tensor:
    return x * math.sqrt(2.0 / math.prod(shape[1:]))


def _prelu(x: torch.Tensor, shape, wcfg: Dict) -> torch.Tensor:
    return torch.full_like(x, 0.25)


KINDS = {"relu_weight": _he, "prelu": _prelu}


def _convs(cfg: Dict) -> List[Tuple[str, int, int, bool]]:
    """``(name, cout, kernel, pool after)`` of VGGish's conv blocks."""
    names = ("conv1", "conv2", "conv3_1", "conv3_2", "conv4_1", "conv4_2")
    return [(n, c, k, pool) for n, (c, k, pool) in zip(names, cfg["vggish"]["convs"])]


def _pooled(cfg: Dict) -> Tuple[int, int]:
    frames, bands = cfg["frontend"]["example_frames"], cfg["frontend"]["mel_bands"]
    pools = sum(1 for *_, pool in _convs(cfg) if pool)
    return frames >> pools, bands >> pools


def param_shapes(cfg: Dict):
    shapes: OrderedDict = OrderedDict()
    cin = 1
    for name, cout, k, _ in _convs(cfg):
        shapes[f"encoder.{name}.weight"] = ((cout, cin, k, k), "relu_weight")
        shapes[f"encoder.{name}.bias"] = ((cout,), "bias")
        cin = cout
    h, w = _pooled(cfg)
    width = h * w * cin
    for i, out in enumerate(cfg["vggish"]["fc"], start=1):
        shapes[f"encoder.fc1_{i}.weight"] = ((out, width), "relu_weight")
        shapes[f"encoder.fc1_{i}.bias"] = ((out,), "bias")
        width = out
    emb, hid = cfg["vggish"]["embedding"], cfg["post_hidden"]
    shapes["encoder.fc2.weight"] = ((emb, width), "weight")
    shapes["encoder.fc2.bias"] = ((emb,), "bias")
    width = 2 * emb
    for i in (1, 2):
        shapes[f"post.dense{i}.weight"] = ((hid, width), "weight")
        shapes[f"post.dense{i}.bias"] = ((hid,), "bias")
        shapes[f"post.act{i}.weight"] = ((1,), "prelu")
        width = hid
    shapes["post.dense3.weight"] = ((cfg["num_params"], width), "weight")
    shapes["post.dense3.bias"] = ((cfg["num_params"],), "bias")
    return shapes


# --- features -----------------------------------------------------------------


def _ratio(cfg: Dict) -> Tuple[int, int]:
    """``(up, down)``: the resampling ratio in lowest terms (160, 441)."""
    sr_in, sr = cfg["sample_rate"], cfg["frontend"]["sample_rate"]
    g = math.gcd(sr_in, sr)
    return sr // g, sr_in // g


def _filter(u: np.ndarray, spec: Dict) -> np.ndarray:
    zeros, r, beta = spec["zero_crossings"], spec["rolloff"], spec["kaiser_beta"]
    u = np.abs(u)
    ratio = np.minimum(u / zeros, 1.0)
    taper = np.i0(beta * np.sqrt(1.0 - ratio * ratio)) / np.i0(beta)
    return np.where(u <= zeros, r * np.sinc(r * u) * taper, 0.0)


def _polyphase(cfg: Dict) -> Tuple[np.ndarray, int]:
    """``(weights [up, span], before)``: output ``up q + p`` is the sum over
    ``j`` of ``weights[p, j] * x[down q - before + j]``."""
    up, down = _ratio(cfg)
    spec = cfg["frontend"]["resampler"]
    scale = up / down
    reach = spec["zero_crossings"] / scale
    before = math.ceil(reach)
    span = before + math.floor((up - 1) * down / up + reach) + 1
    p = np.arange(up, dtype=np.float64)[:, None]
    j = np.arange(span, dtype=np.float64)[None, :]
    return scale * _filter(scale * (p * down / up - (j - before)), spec), before


def _mel(fe: Dict) -> np.ndarray:
    bins = fe["n_fft"] // 2 + 1

    def mel(hz):
        return 1127.0 * np.log1p(np.asarray(hz, dtype=np.float64) / 700.0)

    at = mel(np.linspace(0.0, fe["sample_rate"] / 2.0, bins))
    edges = np.linspace(mel(fe["mel_hz"][0]), mel(fe["mel_hz"][1]), fe["mel_bands"] + 2)
    w = np.zeros((bins, fe["mel_bands"]))
    for i in range(fe["mel_bands"]):
        lo, mid, hi = edges[i], edges[i + 1], edges[i + 2]
        w[:, i] = np.clip(np.minimum((at - lo) / (mid - lo), (hi - at) / (hi - mid)), 0.0, None)
    w[0] = 0.0
    return w


def _track_examples(x: torch.Tensor, first: int, count: int, cfg: Dict, table: torch.Tensor,
                    before: int, mel: torch.Tensor) -> torch.Tensor:
    """Examples ``[first, first + count)`` of one track ``x [S]`` (on the
    device) -> ``[count, frames, bands]`` float32, in float64 throughout."""
    fe = cfg["frontend"]
    up, down = _ratio(cfg)
    span = table.shape[1]
    per = fe["example_frames"]  # frames per example = resampler steps per chunk
    frames = count * per
    steps = frames + -(-(fe["window"] - fe["hop"]) // up)
    start = first * per * down - before  # input index of the first step's window
    stop = start + (steps - 1) * down + span
    xs = x.to(torch.float64)[max(start, 0):max(min(stop, x.shape[0]), 0)]
    xs = F.pad(xs, (max(-start, 0), stop - start - max(-start, 0) - xs.shape[0]))
    y = (xs.unfold(0, span, down) @ table.T).reshape(-1)  # 16 kHz from frame 96 first
    k = torch.arange(fe["window"], dtype=torch.float64, device=x.device)
    hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / fe["window"])
    framed = y.unfold(0, fe["window"], fe["hop"])[:frames] * hann
    mag = torch.fft.rfft(framed, n=fe["n_fft"]).abs()
    logmel = torch.log(mag @ mel + fe["log_offset"])
    return logmel.to(torch.float32).reshape(count, per, -1)


def features(stems: torch.Tensor, first: int, count: int, cfg: Dict) -> torch.Tensor:
    """Examples ``[first, first + count)`` of every track of the whole song
    ``stems [tracks, S]`` (a tensor on the device) -> ``[count, tracks,
    frames, bands]``: each track resampled and framed as the whole track,
    its inputs outside the song zero."""
    table, before = _polyphase(cfg)
    table = torch.as_tensor(table, device=stems.device)
    mel = torch.as_tensor(_mel(cfg["frontend"]), device=stems.device)
    return torch.stack([_track_examples(t, first, count, cfg, table, before, mel)
                        for t in stems], dim=1)


# --- model --------------------------------------------------------------------


def _logits(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    n, tracks = x.shape[:2]
    h = x.reshape(n * tracks, 1, *x.shape[2:])
    for name, _, k, pool in _convs(cfg):
        h = torch.relu(F.conv2d(h, w[f"encoder.{name}.weight"], w[f"encoder.{name}.bias"],
                                padding=k // 2))
        if pool:
            h = F.max_pool2d(h, 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(n * tracks, -1)  # NHWC order, as vggish_slim
    for i in range(1, len(cfg["vggish"]["fc"]) + 1):
        h = torch.relu(F.linear(h, w[f"encoder.fc1_{i}.weight"], w[f"encoder.fc1_{i}.bias"]))
    e = F.linear(h, w["encoder.fc2.weight"], w["encoder.fc2.bias"]).reshape(n, tracks, -1)
    h = torch.cat([e, e.mean(dim=1, keepdim=True).expand_as(e)], dim=-1)
    for i in (1, 2):
        h = F.prelu(F.linear(h, w[f"post.dense{i}.weight"], w[f"post.dense{i}.bias"]),
                    w[f"post.act{i}.weight"])
    return F.linear(h, w["post.dense3.weight"], w["post.dense3.bias"])


def forward(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict,
            calibrate: bool = False) -> torch.Tensor:
    """``x [chunks, tracks, frames, bands]`` -> ``(a_L, a_R)`` ``[chunks,
    tracks, 2]``; with ``calibrate`` the last dense layer is first scaled so
    that both logits have zero mean and unit deviation over the batch."""
    z = _logits(w, x, cfg)
    if calibrate:
        flat = z.reshape(-1, z.shape[-1])
        mean, std = flat.mean(dim=0), flat.std(dim=0, unbiased=False)
        w["post.dense3.weight"].div_(std[:, None])
        w["post.dense3.bias"].sub_(mean).div_(std)
        z = _logits(w, x, cfg)
    p = torch.sigmoid(z)
    lo, hi = cfg["gain_db"]
    gain = torch.pow(10.0, (lo + (hi - lo) * p[..., 0]) / 20.0)
    theta = p[..., 1] * (math.pi / 2)
    return torch.stack([gain * torch.cos(theta), gain * torch.sin(theta)], dim=-1)


def _amplitudes(weights, stems: np.ndarray, cfg: Dict, device) -> np.ndarray:
    """``(a_L, a_R)`` of every chunk with a gain, as ``[tracks, 2, n_gains]``
    float64."""
    n_gains = stems.shape[-1] // cfg["chunk_samples"] - 1
    if n_gains <= 0:
        return np.zeros((stems.shape[0], 2, 0))
    x = torch.as_tensor(np.asarray(stems, dtype=np.float32), device=device)
    out = []
    with torch.no_grad():
        for lo in range(0, n_gains, BLOCK):
            n = min(BLOCK, n_gains - lo)
            out.append(forward(weights, features(x, lo, n, cfg), cfg))
    return torch.cat(out).permute(1, 2, 0).double().cpu().numpy()


def clip(weights, stems: np.ndarray, cfg: Dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """``(raw, smoothed)`` ``(a_L, a_R)``, each ``[tracks, 2, n_gains]``."""
    raw = _amplitudes(weights, stems, cfg, device)
    tracks, _, n = raw.shape
    num_chunks = stems.shape[-1] // cfg["chunk_samples"]
    smoothed = epilogue.smooth(raw.reshape(2 * tracks, n), num_chunks, cfg["savgol_polyorder"])
    return raw, smoothed.reshape(tracks, 2, n)


def _stretch(c: torch.Tensor, length: int) -> torch.Tensor:
    """``epilogue.stretch`` on the device: value ``j`` fills ``[j coef,
    (j + 1) coef)``, ``coef = length // n``, the last value the tail."""
    n = c.shape[-1]
    body = c.repeat_interleave(length // n, dim=-1)
    return torch.cat([body, c[..., -1:].expand(*c.shape[:-1], length - body.shape[-1])], -1)


def song(weights, stems: np.ndarray, cfg: Dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """``(curves [tracks, 2, n_gains], stereo mix [2, S])``: what
    ``mix_song_smooth_device`` returns, in float64; each track is scaled
    into both channels and summed track by track, on the device."""
    curves = clip(weights, stems, cfg, device)[1]
    S = stems.shape[-1]
    mix = torch.zeros((2, S), dtype=torch.float64, device=device)
    for i, t in enumerate(stems):
        t = torch.as_tensor(np.asarray(t, dtype=np.float32), device=device).double()
        if curves.shape[-1]:
            t = t * _stretch(torch.as_tensor(curves[i], device=device), S)
        mix += t
    peak = mix.abs().max()
    return curves, (mix / peak if peak > 0 else mix).cpu().numpy()


# --- counts -------------------------------------------------------------------


def trunk_layers(cfg: Dict) -> Tuple[List[Tuple[str, int]], Tuple[int, int, int]]:
    """FLOPs of one chunk (every track's example) through VGGish, layer by
    layer, and the embedding ``(channels, 1, 1)``."""
    tracks = cfg["num_stems"]
    h, w = cfg["frontend"]["example_frames"], cfg["frontend"]["mel_bands"]
    cin, out = 1, []
    for name, cout, k, pool in _convs(cfg):
        out.append((name, tracks * 2 * h * w * k * k * cin * cout))  # SAME: output = input
        cin = cout
        if pool:
            h, w = h // 2, w // 2
    width = h * w * cin
    for i, n in enumerate(cfg["vggish"]["fc"], start=1):
        out.append((f"fc1_{i}", tracks * 2 * width * n))
        width = n
    emb = cfg["vggish"]["embedding"]
    out.append(("fc2", tracks * 2 * width * emb))
    return out, (emb, 1, 1)


def model_flops_per_chunk(cfg: Dict) -> int:
    """VGGish and the post-processor for every track of a chunk."""
    hid = cfg["post_hidden"]
    post = 2 * (2 * cfg["vggish"]["embedding"] * hid + hid * hid + hid * cfg["num_params"])
    return sum(f for _, f in trunk_layers(cfg)[0]) + cfg["num_stems"] * post


def frontend_bytes_per_chunk(cfg: Dict) -> int:
    """Least bytes of the frontend for one chunk of every track: the 44.1 kHz
    float32 samples read once, the float32 example written once."""
    fe = cfg["frontend"]
    example = fe["example_frames"] * fe["mel_bands"]
    return cfg["num_stems"] * (cfg["chunk_samples"] + example) * 4
