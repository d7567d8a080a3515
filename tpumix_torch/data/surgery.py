"""MedleyDB "data surgery": group raw per-instrument stems into the four
category stems (bass/drums/vocals/other) the mixing models consume (a copy
of tpumix/data/surgery.py; ``yaml`` is imported where it is used).

Replaces the reference's one-shot notebook (reference
data/medleydb_data_surgery.ipynb cells 4-10) with a library + CLI:

* instrument -> category mapping (notebook cell 4 instrument sets; a stem is
  'bass' also when its METADATA ``component`` says so — cell 5);
* ``group_stem_ids(song_path)`` reads ``{song}_METADATA.yaml`` and buckets
  stem ids (cell 5);
* ``sum_stems`` accumulates the raw ``{song}_STEMS/*.wav`` into
  ``{song}_STEMS_JOINED/{song}_STEM_{CATEGORY}.wav`` (cell 5);
* ``write_naive_sum`` emits the ``{song}_SUM.wav`` naive stem sum baseline
  (cell 4 of the notebook's earlier section);
* ``process_root`` sweeps a MedleyDB root (cell 6), with per-song manual
  overrides for songs whose metadata buckets are wrong (cell 7 pattern).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from tpumix_torch.data import wavio

DRUM_INSTRUMENTS = frozenset({
    "drum set", "kick drum", "bass drum", "snare drum", "toms", "cymbal", "gong",
    "tabla", "darbuka", "bongo", "doumbek", "tambourine", "drum machine", "timpani",
    "auxiliary percussion", "shaker", "claps",
})
BASS_INSTRUMENTS = frozenset({"electric bass", "double bass"})
VOCAL_INSTRUMENTS = frozenset({
    "male singer", "male rapper", "male speaker", "female singer", "vocalists",
})

CATEGORIES = ("drums", "bass", "vocals", "other")

# Per-song manual bucket fixes (reference medleydb_data_surgery.ipynb cell 12:
# the author re-ran sum_stems with hand-picked stem ids after the metadata
# sweep missed synthesizers playing bass parts).  The notebook preserves the
# concrete assignment for one song; the markdown (cell 11) names four more
# whose hand-fixes were not recorded — they are flagged for review instead.
MANUAL_OVERRIDES: Dict[str, Dict[str, List[str]]] = {
    "TheSoSoGlos_Emergency": {
        "drums": ["03", "06"],
        "bass": ["01", "08"],
        "vocals": ["02", "05"],
        "other": ["04", "07", "09", "10"],
    },
}

# Songs the reference author hand-fixed (surgery notebook cell 11 markdown)
# whose exact stem buckets were NOT recorded in the notebook: a metadata-only
# sweep reproduces known-wrong buckets for these, so process_root warns.
NEEDS_MANUAL_REVIEW = (
    "Lushlife_ToynbeeSuite",
    "TheSoSoGlos_Emergency",
    "EthanHein_HarmonicaFigure",
    "HeladoNegro_MitadDelMundo",
    "MusicDelta_InTheHalloftheMountainKing",
)


def classify_instrument(instrument: str, component: str = "") -> str:
    if instrument in DRUM_INSTRUMENTS:
        return "drums"
    if instrument in BASS_INSTRUMENTS or component == "bass":
        return "bass"
    if instrument in VOCAL_INSTRUMENTS:
        return "vocals"
    return "other"


def group_stem_ids(song_path: str) -> Dict[str, List[str]]:
    """Bucket a song's stem ids by category from its METADATA.yaml."""
    import yaml

    song_name = os.path.basename(os.path.normpath(song_path))
    info_file = os.path.join(song_path, f"{song_name}_METADATA.yaml")
    with open(info_file) as f:
        info = yaml.safe_load(f)

    groups: Dict[str, List[str]] = {c: [] for c in CATEGORIES}
    for stem, meta in info["stems"].items():
        stem_id = stem[1:]  # 'S01' -> '01'
        cat = classify_instrument(meta.get("instrument", ""), meta.get("component", ""))
        groups[cat].append(stem_id)
    return groups


def _load_mono(path: str, sr: int) -> np.ndarray:
    audio, file_sr = wavio.read(path, always_2d=True)
    mono = audio.mean(axis=1).astype(np.float32)
    if file_sr != sr:
        mono = wavio.resample_poly(mono, file_sr, sr, axis=-1).astype(np.float32)
    return mono


def sum_stems(song_path: str, stem_ids: Sequence[str], category: str, sr: int = 44100,
              skip_existing: bool = True) -> Optional[str]:
    """Accumulate raw stems into one category stem wav; returns the path."""
    song_name = os.path.basename(os.path.normpath(song_path))
    stems_dir = os.path.join(song_path, f"{song_name}_STEMS")
    joined_dir = os.path.join(song_path, f"{song_name}_STEMS_JOINED")
    os.makedirs(joined_dir, exist_ok=True)

    out_path = os.path.join(joined_dir, f"{song_name}_STEM_{category.upper()}.wav")
    if skip_existing and os.path.exists(out_path):
        return out_path

    # the mix defines the output length (stems can drift by a few samples)
    mix = _load_mono(os.path.join(song_path, f"{song_name}_MIX.wav"), sr)
    total = np.zeros_like(mix)
    for stem_id in stem_ids:
        stem_path = os.path.join(stems_dir, f"{song_name}_STEM_{stem_id}.wav")
        track = _load_mono(stem_path, sr)
        n = min(len(track), len(total))
        total[:n] += track[:n]
    wavio.write(out_path, total, sr)
    return out_path


def write_naive_sum(song_path: str, sr: int = 44100) -> str:
    """``{song}_SUM.wav``: plain sum of the four category stems (the naive
    baseline wav the notebook exports)."""
    song_name = os.path.basename(os.path.normpath(song_path))
    joined_dir = os.path.join(song_path, f"{song_name}_STEMS_JOINED")
    total = None
    for cat in CATEGORIES:
        stem = _load_mono(os.path.join(joined_dir, f"{song_name}_STEM_{cat.upper()}.wav"), sr)
        total = stem if total is None else total[: len(stem)] + stem[: len(total)]
    out = os.path.join(song_path, f"{song_name}_SUM.wav")
    wavio.write(out, total, sr)
    return out


def process_song(song_path: str, sr: int = 44100,
                 overrides: Optional[Dict[str, List[str]]] = None) -> Dict[str, List[str]]:
    """Group + sum one song; ``overrides`` replaces the metadata bucketing
    (the notebook's manual-fix pattern, cell 7)."""
    groups = overrides or group_stem_ids(song_path)
    for cat in CATEGORIES:
        sum_stems(song_path, groups.get(cat, []), cat, sr=sr)
    return groups


def process_root(root_dir: str, sr: int = 44100, naive_sums: bool = False,
                 manual_overrides: Optional[Dict[str, Dict[str, List[str]]]] = None
                 ) -> List[str]:
    """Sweep a MedleyDB root; returns the processed song names.

    Songs in ``manual_overrides`` (default: :data:`MANUAL_OVERRIDES`) use the
    hand-fixed stem buckets instead of the metadata sweep; songs in
    :data:`NEEDS_MANUAL_REVIEW` without an override emit a warning.
    """
    if manual_overrides is None:
        manual_overrides = MANUAL_OVERRIDES
    done = []
    for song_name in sorted(os.listdir(root_dir)):
        song_path = os.path.join(root_dir, song_name)
        meta = os.path.join(song_path, f"{song_name}_METADATA.yaml")
        if not os.path.isfile(meta):
            continue
        override = manual_overrides.get(song_name)
        if override is None and song_name in NEEDS_MANUAL_REVIEW:
            print(f"[surgery] WARNING: {song_name} is known to need manual "
                  "bucket fixes (reference surgery notebook cell 11) but no "
                  "override is registered — metadata buckets may be wrong")
        print(f"[surgery] {song_name}" + (" (manual override)" if override else ""))
        process_song(song_path, sr=sr, overrides=override)
        if naive_sums:
            write_naive_sum(song_path, sr=sr)
        done.append(song_name)
    return done
