"""Host-side track loading and songlist splitting (a copy of
tpumix/data/loaders.py).

Parity contracts:
* ``load_tracks`` — MedleyDB layout ``{song}_MIX.wav`` +
  ``{song}_STEMS_JOINED/{song}_STEM_{NAME}.wav`` (reference
  data/dataset_utils.py:53-68; same path logic duplicated at
  reference data/dataset.py:77-85).
* ``load_tracks_musdb18`` — MUSDB18 layout ``mixture.wav`` / ``{stem}.wav``
  (reference data/dataset_utils.py:71-83).
* ``split_songlist`` — random train/val/test split by fractions
  (reference data/dataset_utils.py:6-36), with an explicit seed instead of
  global numpy RNG state.

Waveforms are returned as ``[channels, samples]`` float32 (librosa
``mono=False`` convention the reference relies on downstream,
inference_utils.py:107,118) and resampled to the target rate when the file
rate differs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpumix_torch.data import wavio

DEFAULT_TRACKLIST: Tuple[str, ...] = ("bass", "drums", "vocals", "other", "mix")


def medleydb_track_path(base_dir: str, song_name: str, track: str) -> str:
    song_path = os.path.join(base_dir, song_name)
    if track == "mix":
        return os.path.join(song_path, f"{song_name}_MIX.wav")
    return os.path.join(
        song_path, f"{song_name}_STEMS_JOINED", f"{song_name}_STEM_{track.upper()}.wav"
    )


def musdb18_track_path(base_dir: str, song_name: str, track: str) -> str:
    name = "mixture" if track == "mix" else track
    return os.path.join(base_dir, song_name, f"{name}.wav")


def track_path(base_dir: str, song_name: str, track: str, layout: str = "medleydb") -> str:
    if layout == "medleydb":
        return medleydb_track_path(base_dir, song_name, track)
    if layout == "musdb18":
        return musdb18_track_path(base_dir, song_name, track)
    raise ValueError(f"unknown layout {layout!r}")


def _load_one(path: str, sr: int) -> np.ndarray:
    audio, file_sr = wavio.read(path, always_2d=True)  # [samples, ch]
    audio = audio.T.astype(np.float32)  # -> [ch, samples]
    if file_sr != sr:
        audio = wavio.resample_poly(audio, file_sr, sr, axis=-1).astype(np.float32)
    return audio


def load_tracks(
    base_dir: str,
    song_name: str,
    tracklist: Sequence[str] = DEFAULT_TRACKLIST,
    sr: int = 44100,
) -> Dict[str, np.ndarray]:
    """MedleyDB-layout loader: dict of ``[channels, samples]`` arrays."""
    return {
        track: _load_one(medleydb_track_path(base_dir, song_name, track), sr)
        for track in tracklist
    }


def load_tracks_musdb18(
    base_dir: str,
    song_name: str,
    tracklist: Sequence[str] = DEFAULT_TRACKLIST,
    sr: int = 44100,
) -> Dict[str, np.ndarray]:
    """MUSDB18-layout loader: dict of ``[channels, samples]`` arrays."""
    return {
        track: _load_one(musdb18_track_path(base_dir, song_name, track), sr)
        for track in tracklist
    }


def align_track_lengths(tracks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Trim all tracks of a song to the shortest length (the reference's
    manual-mix length-alignment fix, experiments.ipynb cell 57 — some MUSDB
    manual gain mixes drift a few hundred samples from the stems)."""
    n = min(a.shape[-1] for a in tracks.values())
    return {k: a[..., :n] for k, a in tracks.items()}


def discover_songs(base_path: str):
    """Song directories under ``base_path``, sorted — the single source of
    truth for corpus discovery (the dataset's default songlist and the train
    CLI's split both use it; reference default: listdir, data/dataset.py:44-46)."""
    import os

    return sorted(
        name
        for name in os.listdir(base_path)
        if os.path.isdir(os.path.join(base_path, name))
    )


def split_songlist(
    songlist: Sequence[str],
    train_val_test_split: Tuple[float, float, float] = (0.8, 0.2, 0.0),
    seed: Optional[int] = None,
    summary: bool = False,
) -> Tuple[List[str], List[str], List[str]]:
    """Random disjoint train/val/test split by fractions (must sum to 1)."""
    if abs(sum(train_val_test_split) - 1.0) > 1e-9:
        raise ValueError("train/val/test split should sum to 1")

    rng = np.random.default_rng(seed)
    names = list(songlist)
    rng.shuffle(names)

    n = len(names)
    train_len = round(n * train_val_test_split[0])
    val_len = round(n * train_val_test_split[1])

    train = names[:train_len]
    val = names[train_len : train_len + val_len]
    test = names[train_len + val_len :]

    if summary:
        print(f"Dataset split: train={len(train)} val={len(val)} test={len(test)}")
    return train, val, test
