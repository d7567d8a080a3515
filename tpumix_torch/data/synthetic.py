"""Synthetic multitrack data engine (tpumix/data/synthetic.py): training
batches generated on the device, and the host twin that writes evaluation
corpora.

The task has the shape of the real one: four stem families with distinct
spectra (bass: AM sine; drums: decaying noise bursts + 60 Hz kick; vocals:
vibrato tone with a slow envelope; other: band-passed noise), random
presentation levels per (song, stem), and a deterministic "engineer" who
rebalances each stem to a per-class target with content-dependent rides (the
vocal target follows the drums-vs-bass balance, 'other' follows
vocals-vs-drums), which a loudness-normalisation baseline cannot reproduce.

Two implementations of the same family:

* :func:`synth_chunk_batch` — torch, on the generator's device: a training
  batch ``(stems [B, 4, n], mix [B, n])`` made inside the train step, so the
  step reads no file.  It is :func:`synth_render` of :func:`synth_draws`: the
  draws are every random tensor the JAX generator draws, in its order and
  ranges, from a ``torch.Generator`` (the two random streams cannot match);
  the render is the deterministic rest, in float32 as in JAX (a float64
  ``sin(2 pi f t)`` departs from JAX's float32 by up to 2.2e-3 over a
  352800-sample context: a different result, not a more accurate one).
* :func:`make_synth_song` / :func:`write_synth_dataset` — numpy host twin that
  writes full songs as WAVs in the MUSDB18 layout (``test/{song}/{stem}.wav``
  presented stems, ``manual_gain_mixes/{song}/{stem}.wav`` engineer-scaled
  stems), a copy of the JAX package's, byte for byte.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STEMS: Tuple[str, ...] = ("bass", "drums", "vocals", "other")

# presentation-level range (dB RMS, full scale = 0) for raw session stems;
# with the targets below the engineer's amplitude gains stay in ~[0.5, 2.8]
PRESENT_DB: Tuple[float, float] = (-26.0, -14.0)
# per-class engineer target levels (dB RMS)
BASE_TARGETS_DB: Dict[str, float] = {
    "bass": -19.0,
    "drums": -18.0,
    "vocals": -17.0,
    "other": -20.0,
}
# broadband noise bed under every stem at this level below the stem RMS: it
# keeps every spectrogram bin well above the amin floor (-100 dB)
NOISE_BED_DB = -30.0
# content-dependent rides (dB), saturating at +-1 via clip(delta / scale)
RIDE_VOCALS_DB = 3.0
RIDE_OTHER_DB = 2.0
RIDE_SCALE_DB = 10.0

# mix-bus perturbation presets: reverb tail, soft-knee RMS compressor, tanh
# limiter (typical mastering-chain settings, on the heavy side)
BUS_REVERB_TAPS = 8  # sparse multi-tap tail
BUS_REVERB_DELAY_S = 0.009  # per-tap spacing -> ~72 ms tail
BUS_REVERB_GAIN = 0.35  # wet level
BUS_REVERB_DECAY = 0.6  # per-tap decay
BUS_COMP_THRESH_DB = -18.0  # soft-knee RMS compressor
BUS_COMP_RATIO = 3.0
BUS_COMP_KNEE_DB = 6.0
BUS_COMP_WIN_S = 0.02  # envelope window
BUS_LIMIT_DRIVE = 1.6  # tanh soft limiter drive
BUS_KINDS = ("reverb", "comp", "limiter", "full")


def _pad_left(x, k: int, edge: bool):
    """``k`` samples before the last axis: the first sample repeated
    (``edge``) or zeros; numpy or torch."""
    if isinstance(x, np.ndarray):
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(k, 0)], mode="edge" if edge else "constant")
    if edge:
        return torch.cat([x[..., :1].expand(*x.shape[:-1], k), x], dim=-1)
    return F.pad(x, (k, 0))


def _movavg(x, k: int):
    """Causal moving average along the last axis, same length (edge-padded),
    as a difference of cumulative sums in ``x``'s dtype; numpy or torch."""
    xp = np if isinstance(x, np.ndarray) else torch
    c = xp.cumsum(_pad_left(x, k, edge=True), axis=-1)
    return (c[..., k:] - c[..., :-k]) / k


def mix_bus(mix, sr: int, kind: str):
    """Non-ideal mix-bus processing of the engineer's mix along the last axis:
    a sparse reverb tail, a soft-knee RMS compressor and a tanh limiter;
    ``kind`` selects one stage or ``"full"`` for the chain.  A numpy array
    takes the JAX package's numpy branch; a torch tensor is processed on its
    own device, in its own dtype.

    Each stage breaks the exact-gain-sum mix model differently: reverb adds a
    linear, non-instantaneous part; compression is a time-varying
    level-dependent gain; the limiter is memoryless but amplitude-nonlinear.
    """
    if kind not in BUS_KINDS:
        raise ValueError(f"unknown mix_bus kind {kind!r}; expected one of {BUS_KINDS}")
    xp = np if isinstance(mix, np.ndarray) else torch

    if kind in ("reverb", "full"):
        d = max(int(BUS_REVERB_DELAY_S * sr), 1)
        n = mix.shape[-1]
        wet = xp.zeros_like(mix)
        for k in range(1, BUS_REVERB_TAPS + 1):
            wet = wet + (BUS_REVERB_DECAY**k) * _pad_left(mix, k * d, edge=False)[..., :n]
        mix = mix + BUS_REVERB_GAIN * wet
    if kind in ("comp", "full"):
        win = max(int(BUS_COMP_WIN_S * sr), 1)
        env_db = 10.0 * xp.log10(_movavg(mix * mix, win) + 1e-12)
        over = env_db - BUS_COMP_THRESH_DB
        knee = BUS_COMP_KNEE_DB
        slope = 1.0 - 1.0 / BUS_COMP_RATIO
        # gain reduction in dB: 0 below the knee, slope*over above it,
        # quadratic inside the knee (the standard soft-knee law)
        reduction = xp.where(
            over <= -knee / 2,
            xp.zeros_like(over),
            xp.where(over >= knee / 2, slope * over,
                     slope * (over + knee / 2) ** 2 / (2.0 * knee)),
        )
        mix = mix * 10.0 ** (-reduction / 20.0)
    if kind in ("limiter", "full"):
        # unity small-signal slope; only peaks compress
        mix = xp.tanh(mix * BUS_LIMIT_DRIVE) / BUS_LIMIT_DRIVE
    return mix


def engineer_targets_db(u_db):
    """Per-stem engineer target levels given presented levels ``u_db [..., 4]``
    (stem order = STEMS); numpy or torch."""
    xp = np if isinstance(u_db, np.ndarray) else torch
    ride_v = RIDE_VOCALS_DB * xp.clip((u_db[..., 1] - u_db[..., 0]) / RIDE_SCALE_DB, -1.0, 1.0)
    ride_o = RIDE_OTHER_DB * xp.clip((u_db[..., 2] - u_db[..., 1]) / RIDE_SCALE_DB, -1.0, 1.0)
    base = [BASE_TARGETS_DB[s] for s in STEMS]
    zeros = xp.zeros_like(u_db[..., 0])
    return xp.stack(
        [base[0] + zeros, base[1] + zeros, base[2] + ride_v, base[3] + ride_o], axis=-1
    )


# --------------------------------------------------------------------------
# Device-side generator
# --------------------------------------------------------------------------


def synth_draws(generator: torch.Generator, batch: int, n: int, context_mult: int = 1,
                level_shift_db: Optional[Tuple[float, float]] = None) -> Dict[str, object]:
    """Every random tensor of one synthetic batch, drawn from ``generator`` on
    its device, in the order and ranges of the JAX generator's keys
    (tpumix/data/synthetic.py:244-314): ``f0, ph, fam, period, decay, off,
    dnoise, fv, fe, onoise, u_db, beds``, then the optional level shift and
    the per-item window offsets.  ``n`` is the window; the context is
    ``n * context_mult`` samples."""
    B, n_ctx = batch, n * max(int(context_mult), 1)
    dev = generator.device

    def u(lo, hi, shape=(B, 1)):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev)

    two_pi = 2.0 * math.pi
    d = {"n_win": n}
    d["f0"], d["ph"], d["fam"] = u(50.0, 120.0), u(0.0, two_pi, (B, 3)), u(0.1, 0.5)
    d["period"], d["decay"], d["off"] = u(0.3, 0.7), u(8.0, 20.0), u(0.0, 1.0)
    d["dnoise"] = normal((B, n_ctx))
    d["fv"], d["fe"] = u(200.0, 500.0), u(0.2, 0.6)
    d["onoise"] = normal((B, n_ctx))
    d["u_db"] = u(PRESENT_DB[0], PRESENT_DB[1], (B, len(STEMS)))
    d["beds"] = normal((B, len(STEMS), n_ctx))
    d["shift"] = None if level_shift_db is None else u(*level_shift_db)
    d["win_off"] = (None if n_ctx == n else
                    torch.randint(0, n_ctx - n + 1, (B,), generator=generator, device=dev))
    return d


def synth_render(draws: Dict[str, object], sr: int = 44100, return_gains: bool = False,
                 mix_bus_kind: Optional[str] = None):
    """The deterministic part of :func:`synth_chunk_batch`, in float32 on the
    draws' device: ``(stems [B, 4, n], mix [B, n])`` and, with
    ``return_gains``, the engineer's true gains in the model-scalar domain
    ``g = gain_dB / 10`` (``10**(0.5 g)`` is the amplitude gain), ``[B, 4]``.

    Levels, labels and the mix are defined over the whole context and the
    returned arrays are each item's window of it (one indexed gather).  A
    level shift is shared by an item's four stems and folds into the observed
    levels, so the labels are shift-compensated.  ``mix_bus_kind`` runs
    :func:`mix_bus` on the reference mix over the whole context; stems and
    labels stay clean."""
    dnoise = draws["dnoise"]
    B, n = dnoise.shape
    n_win = int(draws["n_win"])
    # a true division on every device: CUDA divides by a Python scalar as a
    # product with its reciprocal, which moves a quarter of the samples by one
    # ulp and, where that crosses a drum hit's restart (the phase wrapping
    # from 1 to 0), an envelope sample from the end of one hit (e^-decay) to
    # the start of the next (1)
    t = (torch.arange(n, dtype=torch.float32, device=dnoise.device)
         / torch.tensor(float(sr), device=dnoise.device))  # [n]
    two_pi = 2.0 * math.pi
    ph = draws["ph"]

    bass = torch.sin(two_pi * draws["f0"] * t + ph[:, 0:1]) * (
        1.0 + 0.3 * torch.sin(two_pi * draws["fam"] * t))
    env = torch.exp(-torch.remainder(t / draws["period"] + draws["off"], 1.0) * draws["decay"])
    drums = dnoise * env + 0.7 * torch.sin(two_pi * 60.0 * t + ph[:, 1:2]) * env * env
    vib = 3.0 * torch.sin(two_pi * 5.5 * t)
    envv = 0.55 + 0.45 * torch.sin(two_pi * draws["fe"] * t + ph[:, 2:3])
    vocals = torch.sin(two_pi * draws["fv"] * t + vib) * envv
    onoise = draws["onoise"]
    other = _movavg(onoise, 8) - _movavg(onoise, 64)

    def unit_rms(x):
        return x / (torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True)) + 1e-8)

    bed_amp = 10.0 ** (NOISE_BED_DB / 20.0)
    stems_unit = torch.stack([unit_rms(bass), unit_rms(drums), unit_rms(vocals),
                              unit_rms(other)], dim=1)
    stems_unit = unit_rms(stems_unit + draws["beds"] * bed_amp)  # [B, 4, n]

    u_db = draws["u_db"]
    if draws["shift"] is not None:
        u_db = u_db + draws["shift"]
    presented = stems_unit * (10.0 ** (u_db / 20.0))[..., None]
    targets = engineer_targets_db(u_db)  # [B, 4]
    gains = 10.0 ** ((targets - u_db) / 20.0)
    mix = torch.sum(presented * gains[..., None], dim=1)  # [B, n]
    if mix_bus_kind is not None:
        mix = mix_bus(mix, sr, mix_bus_kind)

    if n_win < n:
        idx = draws["win_off"][:, None] + torch.arange(n_win, device=mix.device)  # [B, n_win]
        presented = torch.gather(presented, 2, idx[:, None, :].expand(B, len(STEMS), n_win))
        mix = torch.gather(mix, 1, idx)
    if return_gains:
        return presented, mix, (targets - u_db) / 10.0
    return presented, mix


def synth_chunk_batch(generator: torch.Generator, batch: int, n: int, sr: int = 44100,
                      return_gains: bool = False, context_mult: int = 1,
                      level_shift_db: Optional[Tuple[float, float]] = None,
                      mix_bus_kind: Optional[str] = None):
    """Synthetic training batch on ``generator``'s device: ``(stems [B, 4, n],
    mix [B, n])`` (+ the gain labels ``[B, 4]`` with ``return_gains``); see
    :func:`synth_render`.  ``context_mult=K > 1`` defines levels and labels
    over a ``K*n``-sample context and returns a random ``n``-sample window
    of it (the inference distribution: a song's level is song-global);
    ``level_shift_db=(lo, hi)`` draws a shared per-item level shift."""
    return synth_render(synth_draws(generator, batch, n, context_mult, level_shift_db),
                        sr, return_gains=return_gains, mix_bus_kind=mix_bus_kind)


# --------------------------------------------------------------------------
# Host-side twin (full songs, WAV datasets)
# --------------------------------------------------------------------------


def make_synth_song(
    seed: int, duration_s: float = 30.0, sr: int = 44100, bus: Optional[str] = None
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[str, float]]:
    """One full synthetic song.

    :param bus: apply :func:`mix_bus` of this kind to ``engineer['mix']`` (the
        stems stay clean); None keeps the exact gain-sum mix.
    :return: ``(presented, engineer, gains)`` — presented raw-session stems
        (mono ``[n]`` float32), the engineer-scaled stems (same keys), and the
        per-stem engineer amplitude gains.  ``engineer['mix']`` /
        ``presented['mix']`` hold the respective stem sums.
    """
    rng = np.random.default_rng(seed)
    n = int(round(duration_s * sr))
    t = np.arange(n, dtype=np.float64) / sr
    two_pi = 2.0 * np.pi

    bass = np.sin(two_pi * rng.uniform(50, 120) * t + rng.uniform(0, two_pi)) * (
        1.0 + 0.3 * np.sin(two_pi * rng.uniform(0.1, 0.5) * t)
    )

    period = rng.uniform(0.3, 0.7)
    decay = rng.uniform(8.0, 20.0)
    phase = np.mod(t / period + rng.uniform(0, 1), 1.0)
    env = np.exp(-phase * decay)
    drums = rng.standard_normal(n) * env + 0.7 * np.sin(
        two_pi * 60.0 * t + rng.uniform(0, two_pi)
    ) * env * env

    vib = 3.0 * np.sin(two_pi * 5.5 * t)
    envv = 0.55 + 0.45 * np.sin(two_pi * rng.uniform(0.2, 0.6) * t + rng.uniform(0, two_pi))
    vocals = np.sin(two_pi * rng.uniform(200, 500) * t + vib) * envv

    onoise = rng.standard_normal(n)
    other = _movavg(onoise, 8) - _movavg(onoise, 64)

    def unit_rms(x):
        return x / (np.sqrt(np.mean(x * x)) + 1e-8)

    bed_amp = 10.0 ** (NOISE_BED_DB / 20.0)
    stems_unit = {
        s: unit_rms(unit_rms(x) + rng.standard_normal(n) * bed_amp)
        for s, x in zip(STEMS, (bass, drums, vocals, other))
    }
    u_db = rng.uniform(PRESENT_DB[0], PRESENT_DB[1], size=len(STEMS))
    presented = {
        s: (stems_unit[s] * 10.0 ** (u_db[i] / 20.0)).astype(np.float32)
        for i, s in enumerate(STEMS)
    }
    targets = engineer_targets_db(u_db)
    gains = {s: float(10.0 ** ((targets[i] - u_db[i]) / 20.0)) for i, s in enumerate(STEMS)}
    engineer = {s: (presented[s] * gains[s]).astype(np.float32) for s in STEMS}

    presented["mix"] = np.sum([presented[s] for s in STEMS], axis=0).astype(np.float32)
    engineer["mix"] = np.sum([engineer[s] for s in STEMS], axis=0).astype(np.float32)
    if bus is not None:
        engineer["mix"] = mix_bus(engineer["mix"], sr, bus).astype(np.float32)

    # PCM16 headroom: one shared scale keeps every relative relationship (and
    # the evaluator's relative-loudness metric) intact
    peak = max(float(np.max(np.abs(presented[k2]))) for k2 in presented)
    peak = max(peak, max(float(np.max(np.abs(engineer[k2]))) for k2 in engineer))
    if peak > 0.99:
        c = 0.99 / peak
        presented = {k2: (v * c).astype(np.float32) for k2, v in presented.items()}
        engineer = {k2: (v * c).astype(np.float32) for k2, v in engineer.items()}
    return presented, engineer, gains


def synth_songlist(prefix: str, count: int) -> list:
    return [f"{prefix}{i:03d}" for i in range(count)]


def write_synth_dataset(
    root: str,
    n_train: int = 16,
    n_test: int = 8,
    duration_s: float = 30.0,
    sr: int = 44100,
    seed: int = 0,
    train_raw: bool = False,
    bus: Optional[str] = None,
) -> Dict[str, list]:
    """Write a synthetic corpus in the MUSDB18 layout:

    * ``train/{song}/{stem}.wav`` — engineer-scaled train stems,
    * ``test/{song}/{stem}.wav`` — presented raw-session stems,
    * ``manual_gain_mixes/{song}/{stem}.wav`` — engineer-scaled test stems
      (the evaluation reference).

    ``train_raw=True`` writes the training split in the reference's
    supervision layout instead: presented raw-session stems, and the
    engineer's mix as ``mixture.wav`` (what ``train`` learns gains from).
    ``bus`` applies :func:`mix_bus` to every engineer mix.

    Returns ``{"train": [...], "test": [...]}`` songlists.
    """
    from tpumix_torch.data import wavio

    train_songs = synth_songlist("synth_train_", n_train)
    test_songs = synth_songlist("synth_test_", n_test)

    def dump(dirpath: str, tracks: Dict[str, np.ndarray], mix=None) -> None:
        os.makedirs(dirpath, exist_ok=True)
        for stem in STEMS:
            wavio.write(os.path.join(dirpath, f"{stem}.wav"), tracks[stem], sr)
        wavio.write(os.path.join(dirpath, "mixture.wav"),
                    tracks["mix"] if mix is None else mix, sr)

    for i, song in enumerate(train_songs):
        presented, engineer, _ = make_synth_song(seed + i, duration_s, sr, bus=bus)
        if train_raw:
            dump(os.path.join(root, "train", song), presented, mix=engineer["mix"])
        else:
            dump(os.path.join(root, "train", song), engineer)
    for i, song in enumerate(test_songs):
        presented, engineer, _ = make_synth_song(seed + 10_000 + i, duration_s, sr, bus=bus)
        dump(os.path.join(root, "test", song), presented)
        dump(os.path.join(root, "manual_gain_mixes", song), engineer)
    return {"train": train_songs, "test": test_songs}
