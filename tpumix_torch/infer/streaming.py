"""Streaming (live) mixing: causal per-chunk gains with click-free ramps
(tpumix/infer/streaming.py).

The batched mixer needs the whole song up front because Savitzky-Golay
smoothing is non-causal over the whole gain curve.  This is the live variant:

* audio arrives one chunk (``chunk_samples``) at a time per stem;
* each chunk's gains come from a segment-size-1 ``SongMixer`` (one chunk per
  device call: the frontend kernel at ``[1, 4, C]`` and one trunk forward);
* smoothing is causal: a one-pole exponential average over the chunk gain
  sequence, and the applied per-sample gain ramps linearly from the previous
  chunk's value to the new smoothed value across the chunk, so there is no
  click at the boundaries;
* the algorithmic latency is one chunk (its gains exist once it is complete).

The device work is ``SongMixer.song_gains`` (under ``inference_mode`` there);
smoothing and mixing are numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from tpumix_torch.config import MixConfig, ModelConfig
from tpumix_torch.infer.mixer import STEMS, SongMixer


class StreamingMixer:
    """Causal chunk-by-chunk mixer on a segment-size-1 ``SongMixer``.

    Usage::

        sm = StreamingMixer(model, cfg)
        for chunk in live_chunks:          # chunk: [4, C] mono stems
            mixed = sm.push(chunk)         # [C] mixed audio, 1-chunk latency

    ``push`` accepts ``[4, C]`` mono stems or ``[4, channels, C]`` multi-
    channel stems (gains come from the mono downmix and scale every channel,
    the batched mixer's convention).
    """

    def __init__(
        self,
        model,
        model_cfg: ModelConfig,
        smoothing_alpha: float = 0.35,
        transfer_dtype: str = "float32",
        mix_cfg: Optional[MixConfig] = None,
        inner_mixer: Optional[SongMixer] = None,
        device=None,
    ):
        """``smoothing_alpha``: one-pole coefficient in (0, 1] — the weight of
        the new chunk's gain (1.0 = no smoothing); 0.35 averages over about
        three chunks.

        ``inner_mixer``: share an existing segment-size-1 ``SongMixer`` (the
        service hands every connection the same one; smoothing state stays
        per ``StreamingMixer``).  Otherwise one is built here on ``device``
        (``None`` = ``cuda``), which moves ``model`` there."""
        if not 0.0 < smoothing_alpha <= 1.0:
            raise ValueError(f"smoothing_alpha must be in (0, 1], got {smoothing_alpha}")
        if inner_mixer is not None:
            if (inner_mixer.mix_cfg.max_chunks or 0) != 1:
                raise ValueError("inner_mixer must use max_chunks=1 segments")
            self._mixer = inner_mixer
        else:
            inner_cfg = mix_cfg or MixConfig(
                chunk_length_s=model_cfg.chunk_length_s, max_chunks=1
            )
            if inner_cfg.max_chunks != 1:
                inner_cfg = dataclasses.replace(inner_cfg, max_chunks=1)
            self._mixer = SongMixer(model, model_cfg, mix_cfg=inner_cfg,
                                    transfer_dtype=transfer_dtype, device=device)
        self.chunk_samples = self._mixer.chunk_samples
        self.alpha = float(smoothing_alpha)
        self.reset()

    def reset(self) -> None:
        """Forget smoothing state (start of a new stream)."""
        self._g_smooth: Optional[np.ndarray] = None  # [4] amplitude gains
        self._g_applied: Optional[np.ndarray] = None  # last sample's gains

    def _chunk_gains(self, mono: np.ndarray) -> np.ndarray:
        """[4, C] mono chunk -> [4] amplitude gains.  ``song_gains`` computes
        ``n_chunks - 1`` gain windows, so one silent dummy chunk is appended
        and the real chunk is window 0."""
        padded = np.concatenate([mono, np.zeros_like(mono)], axis=1)
        g_db = self._mixer.song_gains(padded)  # [1, 4] model-scalar domain
        return (10.0 ** (0.5 * g_db[0])).astype(np.float64)

    def push(self, stems_chunk: np.ndarray) -> np.ndarray:
        """Mix one chunk: the gain-weighted stem sum with causal smoothing and
        a linear boundary ramp.  Input ``[4, C]`` or ``[4, channels, C]``;
        output ``[C]`` / ``[channels, C]``."""
        x = np.asarray(stems_chunk, dtype=np.float32)
        if x.shape[0] != len(STEMS):
            raise ValueError(f"expected leading stem axis of {len(STEMS)}, got {x.shape}")
        if x.shape[-1] != self.chunk_samples:
            raise ValueError(
                f"chunk must have {self.chunk_samples} samples, got {x.shape[-1]}"
            )
        mono = x.mean(axis=1) if x.ndim == 3 else x

        g_new = self._chunk_gains(mono)
        if self._g_smooth is None:
            self._g_smooth = g_new
            self._g_applied = g_new
        else:
            self._g_smooth = (1.0 - self.alpha) * self._g_smooth + self.alpha * g_new

        # per-sample linear ramp from the previously applied gain to the new
        # smoothed target (no discontinuity at the chunk boundary)
        ramp = np.linspace(0.0, 1.0, self.chunk_samples, endpoint=True)[None, :]
        gains_t = self._g_applied[:, None] + (self._g_smooth - self._g_applied)[:, None] * ramp
        self._g_applied = self._g_smooth.copy()

        gains_t = gains_t.astype(np.float32)
        if x.ndim == 3:
            return np.einsum("sct,st->ct", x, gains_t)
        return np.einsum("st,st->t", x, gains_t)

    def push_tracks(self, tracks: Dict[str, np.ndarray]) -> np.ndarray:
        """Dict convenience wrapper (``STEMS`` order)."""
        return self.push(np.stack([np.asarray(tracks[t]) for t in STEMS]))

    @property
    def current_gains(self) -> Optional[Tuple[float, ...]]:
        """Latest smoothed amplitude gains (None before the first chunk)."""
        if self._g_smooth is None:
            return None
        return tuple(float(v) for v in self._g_smooth)
