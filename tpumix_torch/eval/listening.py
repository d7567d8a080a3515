"""MUSHRA-style listening-test tooling (a copy of tpumix/eval/listening.py on
the port's loaders and loudness meter; ``matplotlib`` is imported where it is
used).

* Data preparation (reference data/listening_test_data_preparation.py:19-64
  parity): for each test song and a hand-picked 30 s window, export -20 LUFS
  loudness-normalised mixtures for the reference (human gain mix), raw sum,
  and each candidate system (random / loudnorm / CNN mixer) as wav files.
* Score parsing (reference data/listening_test_json_parser.py:9-30 parity):
  parse webMUSHRA-style result JSON (``pages[].elements[].axis[0].values``)
  into per-model and per-song score tables; boxplot rendering with median
  annotations ('mix' relabelled 'CNN').
"""

from __future__ import annotations

import itertools
import json
import os
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from tpumix_torch.data import wavio
from tpumix_torch.data.loaders import load_tracks_musdb18
from tpumix_torch.ops.loudness import integrated_loudness, normalize_loudness

STEMS: Tuple[str, ...] = ("bass", "drums", "vocals", "other")

# The reference's hand-picked 30 s windows for the 15 MUSDB18 test songs
# (listening_test_data_preparation.py:137-153), keyed by song name.
DEFAULT_TIME_INTERVALS: Dict[str, Tuple[int, int]] = {
    "Arise - Run Run Run": (80, 110),
    "BKS - Bulldozer": (25, 55),
    "BKS - Too Much": (35, 65),
    "Bobby Nobody - Stitch Up": (65, 95),
    "Cristina Vane - So Easy": (60, 90),
    "Enda Reilly - Cur An Long Ag Seol": (80, 110),
    "Forkupines - Semantics": (150, 180),
    "James Elder & Mark M Thompson - The English Actor": (50, 80),
    "Nerve 9 - Pray For The Rain": (41, 71),
    "Raft Monk - Tiring": (41, 71),
    "Signe Jakobsen - What Have You Done To Me": (41, 71),
    "Speak Softly - Broken Man": (28, 58),
    "The Doppler Shift - Atrophy": (60, 90),
    "Timboz - Pony": (196, 226),
    "Zeno - Signs": (43, 73),
}


def produce_mixture_and_save(
    track_dict: Dict[str, np.ndarray], song_name: str, identifier: str, save_dir: str,
    sr: int = 44100,
) -> str:
    """Sum stems, normalise to -20 LUFS, write wav; returns the path."""
    total = np.sum(np.stack([np.asarray(track_dict[t]) for t in STEMS]), axis=0)
    loud = integrated_loudness(total.T, sr)
    norm = normalize_loudness(total.T, loud, -20.0)
    path = os.path.join(save_dir, f"{song_name}_{identifier}.wav")
    wavio.write(path, norm, sr)
    return path


def process_song(
    base_dir: str,
    song_name: str,
    time_interval: Tuple[int, int],
    models: Dict[str, object],
    save_dir: str,
    sr: int = 44100,
) -> None:
    lo, hi = time_interval[0] * sr, time_interval[1] * sr

    ref = load_tracks_musdb18(
        os.path.join(base_dir, "manual_gain_mixes"), song_name, tracklist=STEMS, sr=sr
    )
    ref = {t: a[:, lo:hi] for t, a in ref.items()}
    produce_mixture_and_save(ref, song_name, "reference", save_dir, sr)

    tracks = load_tracks_musdb18(
        os.path.join(base_dir, "test"), song_name, tracklist=STEMS, sr=sr
    )
    tracks = {t: a[:, lo:hi] for t, a in tracks.items()}
    produce_mixture_and_save(tracks, song_name, "sum", save_dir, sr)

    for name, model in models.items():
        if name == "mix":  # the CNN via the batched SongMixer
            mixed, _, _ = model.mix_song_smooth(tracks)
        else:
            mixed = model.forward(tracks)
        produce_mixture_and_save(mixed, song_name, name, save_dir, sr)


def process_songlist(
    base_dir: str,
    songlist: Sequence[str],
    models: Dict[str, object],
    save_dir: str = "./test_data",
    time_intervals: Dict[str, Tuple[int, int]] = DEFAULT_TIME_INTERVALS,
    sr: int = 44100,
) -> None:
    os.makedirs(save_dir, exist_ok=True)
    for i, song in enumerate(songlist):
        print(f"{i + 1}/{len(songlist)}: {song}")
        process_song(base_dir, song, time_intervals[song], models, save_dir, sr)


# --- score parsing -----------------------------------------------------------

def parse_json(json_path: str):
    """webMUSHRA result JSON -> (scores_by_model, scores_by_song)."""
    with open(json_path) as f:
        data = json.load(f)

    scores_by_model: Dict[str, List[List[float]]] = {
        k: [] for k in ("sum", "reference", "mix", "random", "loudnorm")
    }
    scores_by_song: Dict[str, "OrderedDict[str, List[float]]"] = {}

    for page in data["pages"]:
        song = page["id"]
        scores_by_song[song] = OrderedDict()
        for elem in page["elements"]:
            model_id = elem["id"].split("_")[-1]
            values = elem["axis"][0]["values"]
            scores_by_song[song][model_id] = values
            scores_by_model.setdefault(model_id, []).append(values)
    return scores_by_model, scores_by_song


def global_scores(scores_by_model: Dict[str, List[List[float]]]) -> Dict[str, List[float]]:
    return {
        k: list(itertools.chain.from_iterable(v)) for k, v in scores_by_model.items() if v
    }


def produce_boxplot(data: Sequence[Sequence[float]], keys: Sequence[str], out_path: str):
    """Boxplot with annotated medians; 'mix' relabelled 'CNN'."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 5))
    medianprops = dict(linestyle="-", linewidth=3.0, color="orange")
    bp = plt.boxplot(data, patch_artist=True, medianprops=medianprops)
    for line in bp["medians"]:
        x, y = line.get_xydata()[1]
        plt.text(x, y, f"{y:.2f}", horizontalalignment="left")
    labels = ["CNN" if k == "mix" else k for k in keys]
    plt.xticks(range(1, len(keys) + 1), labels)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
