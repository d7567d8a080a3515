"""Multitrack chunk dataset (a copy of tpumix/data/dataset.py; numpy only).

Functional parity with the reference ``MultitrackAudioDataset``
(reference data/dataset.py:16-304) — songs cut into fixed-length chunks,
per-item 5-track loading (bass/drums/vocals/other/mix), stereo->mono downmix,
optional waveform augmentation, feature computation, precomputed-feature
cache:

* **Waveform-first items**: ``__getitem__`` returns raw audio chunks
  ``(stems [4, S], mix [S])`` by default; the STFT->dB frontend runs inside
  the train step on the device, batched over the whole batch x 5 tracks.  Set
  ``return_features=True`` for reference-shaped ``([4, 1025, T], [1025, T])``
  host-side feature items.
* **Arithmetic chunk indexing**: global chunk index -> (song, chunk) via a
  cumulative-chunk table + searchsorted.
* **No hidden global RNG**: shuffling uses an owned Generator and copies the
  songlist.
* **Working precompute cache**: a single ``.npz`` per song with matching
  read/write paths.
* **Mean-loudness scan**: ``compute_mean_loudness`` on the host BS.1770 meter.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpumix_torch.config import FrontendConfig
from tpumix_torch.data import wavio
from tpumix_torch.data.loaders import discover_songs, track_path
from tpumix_torch.ops.stft import spectrogram_features_np

TRACKLIST: Tuple[str, ...] = ("bass", "drums", "vocals", "other", "mix")
STEMS: Tuple[str, ...] = TRACKLIST[:-1]


class MultitrackAudioDataset:
    """Map-style dataset over songs cut into ``chunk_length``-second chunks."""

    def __init__(
        self,
        base_path: str,
        songlist: Optional[Sequence[str]] = None,
        chunk_length: float = 5.0,
        sr: int = 44100,
        seed: Optional[int] = None,
        normalize: bool = False,
        return_features: bool = False,
        augment_data: bool = False,
        layout: str = "medleydb",
        hop_length: int = 1024,
        cache_dir: Optional[str] = None,
    ):
        self._base_path = base_path
        self._chunk_length = chunk_length
        self._chunk_samples = int(round(chunk_length * sr))
        self._sr = sr
        self._normalize = normalize
        self._return_features = return_features
        self._augment = augment_data
        self._layout = layout
        self._frontend = FrontendConfig(hop_length=hop_length, sample_rate=sr)
        self._cache_dir = cache_dir
        self._rng = np.random.default_rng(seed)

        if not songlist:
            songlist = discover_songs(base_path)
        self.songlist: List[str] = list(songlist)
        self._rng.shuffle(self.songlist)

        self.song_durations = self._scan_song_durations()
        chunks_per_song = np.asarray(
            [int(d // chunk_length) for d in self.song_durations], dtype=np.int64
        )
        # cumulative chunk table: song i owns global chunks [cum[i], cum[i+1])
        self._cum_chunks = np.concatenate([[0], np.cumsum(chunks_per_song)])
        self._len = int(self._cum_chunks[-1])

    # --- indexing ------------------------------------------------------------

    def _scan_song_durations(self) -> List[float]:
        """Metadata-only duration probe per song; durations trimmed to whole
        chunks (reference _calculate_dataset_length, data/dataset.py:56-75)."""
        durations = []
        for song in self.songlist:
            meta = wavio.info(track_path(self._base_path, song, "mix", self._layout))
            d = int(meta.duration)
            durations.append(float(d - (d % self._chunk_length)))
        return durations

    def song_and_chunk(self, index: int) -> Tuple[int, int]:
        """Global chunk index -> (song index, chunk-in-song index) in O(log n)."""
        if not 0 <= index < self._len:
            raise IndexError(index)
        song_i = int(np.searchsorted(self._cum_chunks, index, side="right")) - 1
        return song_i, int(index - self._cum_chunks[song_i])

    def __len__(self) -> int:
        return self._len

    def get_num_songs(self) -> int:
        return len(self.songlist)

    def get_song_durations(self) -> List[float]:
        return list(self.song_durations)

    def get_tracklist(self) -> List[str]:
        return list(TRACKLIST)

    # --- loading -------------------------------------------------------------

    def _read_chunk(self, song: str, track: str, chunk_i: int) -> np.ndarray:
        start = chunk_i * self._chunk_samples
        path = track_path(self._base_path, song, track, self._layout)
        mono = wavio.read_mono(path, start=start, count=self._chunk_samples)
        if mono.shape[0] < self._chunk_samples:  # ragged song tail
            mono = np.pad(mono, (0, self._chunk_samples - mono.shape[0]))
        return mono

    def load_audio_chunk(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(stems [4, S], mix [S])`` float32 waveforms for one global chunk."""
        song_i, chunk_i = self.song_and_chunk(index)
        song = self.songlist[song_i]
        stems = np.stack([self._read_chunk(song, t, chunk_i) for t in STEMS])
        mix = self._read_chunk(song, "mix", chunk_i)
        if self._normalize:
            # peak-normalise each track chunk to [-1, 1].  The reference's own
            # normalisation is commented out (data/dataset.py:160) and the
            # flag only survives in its cache filenames; tpumix defines the
            # semantics the reference docstring promises ("audio ...
            # normalized to the range of [-1, 1]", data/dataset.py:33).
            stems = stems / (np.max(np.abs(stems), axis=-1, keepdims=True) + 1e-12)
            mix = mix / (np.max(np.abs(mix)) + 1e-12)
        if self._augment:
            # ALL FIVE tracks get independent random gains — the mix included
            # (reference data/dataset.py:185-199: the per-track loop covers
            # 'mix', so the supervision target is augmented too)
            gains = self._rng.uniform(0.6, 1.4, size=len(TRACKLIST)).astype(np.float32)
            stems = stems * gains[: len(STEMS), None]
            mix = mix * gains[len(STEMS)]
        return stems, mix

    def compute_features(self, audio: np.ndarray) -> np.ndarray:
        """Host-side frontend, reference contract: ``[1025, frames]`` dB
        features (reference data/dataset.py:132-162)."""
        return spectrogram_features_np(np.asarray(audio, dtype=np.float32), self._frontend)

    def _augment_features(self, features_db: np.ndarray) -> np.ndarray:
        """Feature-domain augmentation for the precomputed path: per-stem
        random gains converted to dB and ADDED to the dB spectrograms
        (reference data/dataset.py:170-179; domain equivalence validated in
        reference experiments.ipynb cells 17-19)."""
        gains = self._rng.uniform(0.6, 1.4, size=features_db.shape[0])
        return features_db + (20.0 * np.log10(gains))[:, None, None].astype(np.float32)

    def _features_for_index(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache_dir is not None:
            cached = self._load_cached(index)
            if cached is not None:
                train_features, gt_features = cached
                if self._augment:
                    train_features = self._augment_features(train_features)
                return train_features, gt_features
        stems, mix = self.load_audio_chunk(index)  # waveform-domain augment inside
        train_features = np.stack([self.compute_features(s) for s in stems])
        gt_features = self.compute_features(mix)
        return train_features, gt_features

    def __getitem__(self, index: int):
        if self._return_features:
            return self._features_for_index(index)
        return self.load_audio_chunk(index)

    # --- precompute cache ----------------------------------------------------

    def _cache_path(self, song: str) -> str:
        tag = f"{self._chunk_length}s_h{self._frontend.hop_length}"
        if self._normalize:
            # normalised features live under a distinct cache name, like the
            # reference's ``_norm`` filename suffix (data/dataset.py:253-263)
            tag += "_norm"
        return os.path.join(self._cache_dir, f"{song}_FEATURES_{tag}.npz")

    def precompute_features(self) -> None:
        """Write per-song feature caches (one .npz per song: arrays
        ``train [chunks, 4, F, T]`` and ``gt [chunks, F, T]``)."""
        if self._cache_dir is None:
            raise ValueError("set cache_dir to enable the cache")
        os.makedirs(self._cache_dir, exist_ok=True)
        for song_i, song in enumerate(self.songlist):
            lo, hi = int(self._cum_chunks[song_i]), int(self._cum_chunks[song_i + 1])
            train, gt = [], []
            for idx in range(lo, hi):
                stems, mix = self.load_audio_chunk(idx)
                train.append(np.stack([self.compute_features(s) for s in stems]))
                gt.append(self.compute_features(mix))
            if train:
                np.savez(self._cache_path(song), train=np.stack(train), gt=np.stack(gt))

    def _load_cached(self, index: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        song_i, chunk_i = self.song_and_chunk(index)
        path = self._cache_path(self.songlist[song_i])
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return z["train"][chunk_i], z["gt"][chunk_i]

    # --- statistics ----------------------------------------------------------

    def compute_mean_loudness(self) -> Dict[str, float]:
        """Mean integrated LUFS per track class over the songlist (reference
        data/dataset.py:115-130; feeds the MeanLoudnessModel baseline), on
        the host meter."""
        from tpumix_torch.ops.loudness import integrated_loudness

        sums = {t: 0.0 for t in TRACKLIST}
        for song in self.songlist:
            for track in TRACKLIST:
                audio, sr = wavio.read(
                    track_path(self._base_path, song, track, self._layout), always_2d=True
                )
                sums[track] += integrated_loudness(audio, sr)
        n = len(self.songlist)
        return {t: sums[t] / n for t in TRACKLIST}
