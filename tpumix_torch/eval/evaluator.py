"""Objective mix-quality evaluation (tpumix/eval/evaluator.py; reference
evaluation.py:21-144).

Metric: per song, each candidate system's mix is compared to the human
``manual_gain_mixes`` reference by the mean absolute difference of per-stem
*relative loudness* — each stem's integrated LUFS minus the mean stem LUFS of
that mix (reference evaluate_loudness :39-46 and
_calculate_diff_between_loudness_dicts :48-53).

Systems (reference process_song :77-116):
  sum       — raw stem sum
  loudnorm  — MeanLoudnessModel baseline (train-set mean LUFS per class)
  mix       — the gain model through ``SongMixer.mix_song_smooth``
  random_k  — N random-gain mixes, error averaged

Outputs: per-song rows + mean row to stats.xlsx and stats.csv; optional
-20 LUFS normalised wav exports per system (reference
_sum_and_evaluate_tracks :58-66).
"""

from __future__ import annotations

import csv
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpumix_torch.data import wavio
from tpumix_torch.data.loaders import align_track_lengths, load_tracks_musdb18
from tpumix_torch.models.baselines import MeanLoudnessModel, RandomModel
from tpumix_torch.ops.loudness import (
    integrated_loudness,
    integrated_loudness_torch,
    normalize_loudness,
)
from tpumix_torch.utils.device import resolve_device
from tpumix_torch.utils.xlsx import write_xlsx

STEMS: Tuple[str, ...] = ("bass", "drums", "vocals", "other")


class LoudnessEvaluator:
    """Compare mixing systems by relative-loudness error against human mixes."""

    def __init__(
        self,
        mixer,
        mean_loudness: Dict[str, float],
        sr: int = 44100,
        seed: Optional[int] = None,
        results_dir: str = "./experiment",
        device_meter: bool = False,
        device=None,
    ):
        """``mixer``: a ``SongMixer``, or None to skip the 'mix' system.

        ``device_meter=True`` meters on ``device`` (``None`` = ``cuda``; it
        raises without a card) with :func:`integrated_loudness_torch`: the
        four stems of a song in one batched call instead of four host IIR
        passes, within 0.1 LU of the host meter.  ``device`` is read only by
        the device meter."""
        self.sr = sr
        self.mixer = mixer
        self.mean_loudness_model = MeanLoudnessModel(mean_loudness, sr=sr)
        self.random_model = RandomModel(rng=np.random.default_rng(seed))
        self.results_dir = results_dir
        self.device_meter = device_meter
        if device_meter:
            self.device = resolve_device(device)
        os.makedirs(results_dir, exist_ok=True)

    # --- metric --------------------------------------------------------------

    def evaluate_loudness(self, tracks: Dict[str, np.ndarray]) -> List[float]:
        """Per-stem loudness, centred on the mean stem loudness
        (reference evaluate_loudness, evaluation.py:39-46)."""
        if self.device_meter:
            batch = np.stack(
                [np.atleast_2d(np.asarray(tracks[t], dtype=np.float32)) for t in STEMS]
            )  # [4, channels, samples]
            # the sample axis is padded to the next power of two, as in the
            # JAX package (which buckets to bound its compiles), so the two
            # meters see the same input; silent 400 ms blocks fall below the
            # absolute gate and leave both gating stages
            n = batch.shape[-1]
            bucket = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 14)
            if bucket != n:
                batch = np.pad(batch, ((0, 0), (0, 0), (0, bucket - n)))
            lufs = integrated_loudness_torch(torch.from_numpy(batch).to(self.device),
                                             float(self.sr))
            per_track = [float(v) for v in lufs.cpu().numpy()]
        else:
            per_track = [
                integrated_loudness(np.asarray(tracks[t]).T, self.sr) for t in STEMS
            ]
        avg = float(np.mean(per_track))
        return [l - avg for l in per_track]

    @staticmethod
    def loudness_dict_diff(d1: "OrderedDict[str, float]", d2: "OrderedDict[str, float]") -> float:
        a1 = np.asarray(list(d1.values()))
        a2 = np.asarray(list(d2.values()))
        return float(np.mean(np.abs(a1 - a2)))

    def _sum_and_evaluate(
        self,
        track_dict: Dict[str, np.ndarray],
        reference_dict: Optional["OrderedDict[str, float]"],
        song_name: str,
        identifier: str,
        write_to_disk: bool = False,
    ):
        if write_to_disk:
            total = np.sum(np.stack([np.asarray(track_dict[t]) for t in STEMS]), axis=0)
            loud = integrated_loudness(total.T, self.sr)
            norm = normalize_loudness(total.T, loud, -20.0)
            wavio.write(
                os.path.join(self.results_dir, f"{song_name}_{identifier}.wav"), norm, self.sr
            )
        ld = OrderedDict(zip(STEMS, self.evaluate_loudness(track_dict)))
        if reference_dict is not None:
            return ld, self.loudness_dict_diff(ld, reference_dict)
        return ld, None

    # --- drivers -------------------------------------------------------------

    def process_song(
        self,
        base_dir: str,
        song_name: str,
        n_random_samples: int = 5,
        write_wavs_to_disk: bool = False,
    ) -> Dict[str, object]:
        stats: Dict[str, object] = {"song_name": song_name}

        # manual gain mixes drift a few hundred samples from the stems in
        # real MUSDB data; trim each track dict to its shortest member (the
        # reference aligned these offline, experiments.ipynb cell 57)
        ref_tracks = align_track_lengths(load_tracks_musdb18(
            os.path.join(base_dir, "manual_gain_mixes"), song_name, tracklist=STEMS, sr=self.sr
        ))
        reference, _ = self._sum_and_evaluate(
            ref_tracks, None, song_name, "reference", write_wavs_to_disk
        )

        tracks = align_track_lengths(load_tracks_musdb18(
            os.path.join(base_dir, "test"), song_name, tracklist=STEMS, sr=self.sr
        ))
        _, stats["sum_error"] = self._sum_and_evaluate(
            tracks, reference, song_name, "sum", write_wavs_to_disk
        )

        loudnorm = self.mean_loudness_model.forward(tracks)
        _, stats["loudnorm_error"] = self._sum_and_evaluate(
            loudnorm, reference, song_name, "loudnorm", write_wavs_to_disk
        )

        if self.mixer is not None:
            mixed, _, _ = self.mixer.mix_song_smooth(tracks)
            _, stats["mix_error"] = self._sum_and_evaluate(
                mixed, reference, song_name, "mix", write_wavs_to_disk
            )
        else:
            stats["mix_error"] = float("nan")

        random_errors = []
        for k in range(n_random_samples):
            rnd = self.random_model.forward(tracks)
            _, err = self._sum_and_evaluate(
                rnd, reference, song_name, f"random_{k}", write_wavs_to_disk
            )
            random_errors.append(err)
        stats["random_error"] = float(np.mean(random_errors))
        return stats

    def process_songlist(
        self,
        base_dir: str,
        songlist: Sequence[str],
        write_to_disk: bool = False,
        out_path: str = "./stats.xlsx",
    ) -> List[Dict[str, object]]:
        keys = ["song_name", "sum_error", "random_error", "loudnorm_error", "mix_error"]
        rows: List[List[object]] = [keys]
        all_stats = []
        for i, song in enumerate(songlist):
            print(f"{i + 1}/{len(songlist)}: {song}")
            stats = self.process_song(base_dir, song, write_wavs_to_disk=write_to_disk)
            all_stats.append(stats)
            rows.append(
                [stats["song_name"]] + [f"{stats[k]:.4f}" for k in keys[1:]]
            )
        means = ["Mean"] + [
            f"{np.mean([s[k] for s in all_stats]):.2f}" for k in keys[1:]
        ]
        rows.append(means)

        write_xlsx(out_path, rows)
        with open(os.path.splitext(out_path)[0] + ".csv", "w", newline="") as f:
            csv.writer(f).writerows(rows)
        return all_stats
