"""Device-resident training corpus (tpumix/data/device_corpus.py): upload the
songs once, batch on the device.

The host file-corpus path (disk -> ``MultitrackAudioDataset`` ->
``BatchIterator`` -> prefetch -> step) reads, assembles and copies every
batch on the host; on the card a ``[48, 4, 88200]`` step waits most of its
wall time on it.  A mixing corpus is small next to the card's memory (a
32-song x 30 s synthetic corpus is ~0.4 GB as int16), so this path quantises
each song to int16 PCM on the host, uploads the whole corpus once, and
assembles every batch with one indexed gather on the device.  Per step the
host sends a ``[B]`` vector of sample offsets; the train step dequantises
the int16 chunks by dtype, as on the int16 wire (``_dequantize_on_device``).

Scope: corpora that fit the card next to the model and optimizer; bigger
ones keep the streaming ``BatchIterator`` path.  Both feed ``Trainer.fit``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpumix_torch.data import wavio
from tpumix_torch.data.dataset import STEMS, TRACKLIST
from tpumix_torch.data.loaders import track_path
from tpumix_torch.utils.device import resolve_device


class DeviceCorpus:
    """All songs of a corpus split as ONE flat int16 tensor ``[5,
    total_samples]`` on ``device``, plus per-song sample offsets.

    Songs are packed end to end (no padding of every song to the longest); a
    chunk is ``corpus[:, offset[song] + chunk*C : +C]``.

    :param base_path: corpus root (one directory per song).
    :param songlist: song names to load.
    :param chunk_samples: training chunk length in samples.
    :param layout: ``"medleydb"`` or ``"musdb18"`` (tpumix_torch.data.loaders).
    :param device: ``None`` = ``cuda`` (raises without a card); ``"cpu"``
        keeps the corpus in host memory.
    """

    def __init__(self, base_path: str, songlist: Sequence[str], chunk_samples: int,
                 layout: str = "musdb18", device=None):
        self.device = resolve_device(device)
        if not songlist:
            raise ValueError("DeviceCorpus needs a non-empty songlist")
        self.songlist = list(songlist)
        self.chunk_samples = int(chunk_samples)

        rows = []
        chunks_per_song = []
        for song in self.songlist:
            tracks = [wavio.read_mono(track_path(base_path, song, t, layout)) for t in TRACKLIST]
            n = min(t.shape[0] for t in tracks)  # ragged tails align short
            chunks_per_song.append(n // self.chunk_samples)
            rows.append(np.stack([t[:n] for t in tracks]))  # [5, n] float32
        if max(chunks_per_song) == 0:
            raise ValueError(f"no song in {base_path} is >= one chunk ({chunk_samples} samples)")
        lengths = np.array([r.shape[1] for r in rows], np.int64)
        total = int(lengths.sum())
        if total > np.iinfo(np.int32).max:
            # the JAX package's sample starts are int32; keep its limit (~13.5
            # hours of 44.1 kHz audio per track) so one corpus serves both
            raise ValueError(f"corpus too large for one flat int16 pack ({total} samples/track)")
        corpus = np.empty((len(TRACKLIST), total), np.int16)
        self._offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
        for i, r in enumerate(rows):
            corpus[:, self._offsets[i]: self._offsets[i + 1]] = np.clip(
                np.rint(r * 32768.0), -32768, 32767).astype(np.int16)

        # the ONE corpus upload of the run
        self.corpus = torch.from_numpy(corpus).to(self.device)
        self._cum = np.concatenate([[0], np.cumsum(chunks_per_song)])
        self.num_chunks = int(self._cum[-1])
        self._window = torch.arange(self.chunk_samples, device=self.device)

    def index_table(self) -> np.ndarray:
        """``[num_chunks, 2]`` int32 (song_i, chunk_i) rows."""
        rows = np.empty((self.num_chunks, 2), np.int32)
        for s in range(len(self.songlist)):
            lo, hi = self._cum[s], self._cum[s + 1]
            rows[lo:hi, 0] = s
            rows[lo:hi, 1] = np.arange(hi - lo)
        return rows

    def batch(self, song_idx: np.ndarray, chunk_idx: np.ndarray):
        """One batch assembled on the device by one indexed gather: int16
        ``(stems [B, 4, C], mix [B, C])``.  The ``[B]`` start vector is the
        only host->device traffic."""
        starts = (self._offsets[np.asarray(song_idx, np.int64)]
                  + np.asarray(chunk_idx, np.int64) * self.chunk_samples)
        starts = torch.from_numpy(starts)
        if self.device.type == "cuda":
            # from page-locked memory the copy is queued behind the running
            # step instead of making the host wait for it
            starts = starts.pin_memory().to(self.device, non_blocking=True)
        out = self.corpus[:, starts[:, None] + self._window]  # [5, B, C]
        return out[: len(STEMS)].transpose(0, 1).contiguous(), out[len(STEMS)]


class DeviceCorpusIterator:
    """Shuffled epoch iterator over a :class:`DeviceCorpus`, yielding device
    ``(stems [B, 4, C] int16, mix [B, C] int16)`` batches — a drop-in for
    ``BatchIterator`` in ``Trainer.fit``, which hands device batches straight
    to the step.  The order is the JAX package's for the same seed;
    ``drop_last`` keeps shapes static.

    ``num_shards`` / ``shard_index``: data parallelism.  Every rank builds the
    iterator with the same seed, the global batch is ``batch_size *
    num_shards`` chunks of that one order, and rank ``shard_index`` gathers
    its contiguous block of each (the rows a one-process step on the global
    batch gives it, tpumix_torch/parallel/mesh.py).  The remainder is
    dropped, so every rank runs the same number of steps."""

    def __init__(self, corpus: DeviceCorpus, batch_size: int, shuffle: bool = True,
                 seed: Optional[int] = None, drop_last: bool = True, num_shards: int = 1,
                 shard_index: int = 0):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
        self.corpus = corpus
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last or num_shards > 1
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._rng = np.random.default_rng(seed)
        self._table = corpus.index_table()

    def __len__(self) -> int:
        n, step = self.corpus.num_chunks, self.batch_size * self.num_shards
        return n // step if self.drop_last else -(-n // step)

    def __iter__(self):
        order = np.arange(self.corpus.num_chunks)
        if self.shuffle:
            self._rng.shuffle(order)
        step = self.batch_size * self.num_shards
        stop = len(self) * step if self.drop_last else len(order)
        for lo in range(0, stop, step):
            lo += self.shard_index * self.batch_size
            rows = self._table[order[lo: lo + self.batch_size]]
            yield self.corpus.batch(rows[:, 0], rows[:, 1])
