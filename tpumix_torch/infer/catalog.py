"""Catalogue mixing (tpumix/infer/catalog.py): mix every song of a
songlist, with disk reads of song k+1 on a background thread while song k
runs on the device.  Writes ``{song}_mixed.wav`` (and ``{song}_sum.wav`` with
``naive_sum``), as the reference's inference.ipynb cell 9 does.  Also the
gain-curve plot (``matplotlib`` imported where it is used).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Sequence

import numpy as np

from tpumix_torch.data import wavio
from tpumix_torch.data.loaders import load_tracks, load_tracks_musdb18

STEMS = ("bass", "drums", "vocals", "other")


def plot_gain_curves(raw_gains: Dict[str, list], smooth_gains: Dict[str, list],
                     out_path: str, title: str = "") -> str:
    """Per-stem raw vs smoothed gain-curve plot (the reference's single-song
    inspection cells, inference.ipynb cells 11-14)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(10, 6), sharex=True)
    for ax, stem in zip(axes.ravel(), STEMS):
        ax.plot(raw_gains[stem], alpha=0.5, label="raw")
        ax.plot(smooth_gains[stem], label="smoothed")
        ax.set_title(stem)
        ax.legend(fontsize=8)
    if title:
        fig.suptitle(title)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def mix_catalog(
    mixer,
    base_dir: str,
    songlist: Sequence[str],
    out_dir: str,
    layout: str = "medleydb",
    naive_sum: bool = False,
    prefetch: int = 2,
    sr: int = 44100,
    on_written=None,
    device_mix: bool = False,
) -> List[str]:
    """Mix each song; returns the written mixed-wav paths.

    ``on_written(path)`` fires as each file lands.  ``device_mix=True`` runs
    the whole mix on the device (``SongMixer.mix_song_smooth_device``) and
    writes the mono downmix; the default host epilogue scales the original,
    possibly stereo, tracks before summing."""
    os.makedirs(out_dir, exist_ok=True)
    loader = load_tracks_musdb18 if layout == "musdb18" else load_tracks

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    _END = object()

    def producer():
        try:
            for song in songlist:
                q.put((song, loader(base_dir, song, tracklist=STEMS, sr=sr), None))
        except BaseException as e:  # handed to the consumer, which re-raises
            q.put((None, None, e))
            return
        q.put(_END)

    reader = threading.Thread(target=producer, daemon=True)
    reader.start()

    pending = []  # (song, tracks, mono_stems, handle)
    written: List[str] = []

    def drain_one():
        song, tracks, mono_stems, handle = pending.pop(0)
        out_path = os.path.join(out_dir, f"{song}_mixed.wav")
        if device_mix:
            total = handle[1].cpu().numpy().astype(np.float32)  # already normalised
            wavio.write(out_path, total, sr)
        else:
            gains = mixer.collect_gains(handle)
            mixed_tracks, _, _ = mixer._apply_gains(tracks, mono_stems.shape[1], gains)
            total = sum(np.asarray(v, dtype=np.float32) for v in mixed_tracks.values())
            peak = float(np.max(np.abs(total))) or 1.0
            wavio.write(out_path, (total / peak).T, sr)
        written.append(out_path)
        if on_written is not None:
            on_written(out_path)
        if naive_sum:
            raw_total = sum(np.asarray(v, dtype=np.float32) for v in tracks.values())
            rp = float(np.max(np.abs(raw_total))) or 1.0
            wavio.write(os.path.join(out_dir, f"{song}_sum.wav"), (raw_total / rp).T, sr)

    while True:
        item = q.get()
        if item is _END:
            break
        song, tracks, err = item
        if err is not None:
            raise err
        mono_stems = np.stack([mixer._mono(tracks[t]) for t in STEMS])
        handle = (
            mixer.mix_song_smooth_device(mono_stems)
            if device_mix
            else mixer.song_gains_async(mono_stems)
        )
        pending.append((song, tracks, mono_stems, handle))
        while len(pending) > prefetch:
            drain_one()
    while pending:
        drain_one()
    reader.join()
    return written
