"""Full-song mixing: gains for every chunk, 64 chunks per device call
(tpumix/infer/mixer.py).

    waveforms [4, S] -> wire format -> device -> decode -> [n, 4, C] chunks ->
    DIF frontend [n, 4, T, F] -> conv trunk + heads -> gains [n, 4]

then a host epilogue applies the reference's smoothing semantics:
``10**(0.5 g)`` dB -> amplitude (inference_utils.py:129), Savitzky-Golay with
window ``num_chunks // 4`` forced odd, polyorder 2 (:137-140), the
nearest-neighbour stretch to sample level (:12-41), and per-stem scaling
(:142-143).  ``mix_song_smooth_device`` runs that epilogue on the card too.

A model of ``features="vggish"`` (the Differentiable Mixing Console,
``preset("dmc_vggish")``) takes any number N of tracks and mixes to stereo,
through ``mix_song_smooth_device`` alone:

    tracks [N, S] -> device -> per segment, its chunks' slice with the
    resampler's and the frames' halo (ops/vggish.py) -> log-mel examples
    [n, N, 96, 64] -> encoder, context, post-processor, console ->
    (a_L, a_R) [n, N, 2]

then the same smoothing and mask stretch on the ``2N`` rows of ``a_L`` and
``a_R``, each track scaled into both channels, summed to a peak-normalised
stereo mix ``[2, S]``.

Reference semantics kept on purpose:
* gains exist for windows ``[(i-1)C, iC)``, ``i in 1..num_chunks``: the LAST
  chunk gets no gain and the curve has ``num_chunks - 1`` entries;
* features come from the mono downmix; gains scale the full (stereo)
  waveform;
* ``10**(0.5 g)`` on float32 gains overflows to inf on extreme gains, in
  the host epilogue exactly as in the JAX package (ROADMAP.md, Faults).
"""

from __future__ import annotations

import functools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpumix_torch.config import MixConfig, ModelConfig
from tpumix_torch.ops import vggish
from tpumix_torch.ops.smoothing import (
    default_savgol_window,
    interpolate_mask,
    interpolate_mask_np,
    savgol_smooth,
    savgol_smooth_torch,
)
from tpumix_torch.ops.stft import spectrogram_features_tm
from tpumix_torch.utils.device import disable_tf32, resolve_device
from tpumix_torch.utils.profiling import carry, count, span

STEMS: Tuple[str, ...] = ("bass", "drums", "vocals", "other")

SEGMENT_CHUNKS = 64  # chunks per device call (one fixed shape, any song)

_WIRE_DTYPES = {"float32": np.float32, "int16": np.int16, "int12": np.uint8, "mulaw8": np.int8}


@functools.lru_cache(maxsize=1)
def _mulaw_lut() -> np.ndarray:
    """PCM16 -> mu-law int8 encode table (mu=255), indexed by ``pcm + 32768``."""
    x = np.arange(-32768, 32768, dtype=np.float64) / 32768.0
    y = np.sign(x) * np.log1p(255.0 * np.abs(x)) / np.log(256.0)
    return np.clip(np.rint(y * 127.0), -127, 127).astype(np.int8)


def _dequantize_on_device(x: torch.Tensor, scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Device-side decode of the wire format: int16 = linear PCM; int8 =
    mu-law (mu=255); uint8 = packed 12-bit linear with per-row peak
    ``scales`` (two samples per three bytes); float32 passes through."""
    if x.dtype == torch.int16:
        return x.to(torch.float32) * (1.0 / 32768.0)
    if x.dtype == torch.int8:
        y = x.to(torch.float32) * (1.0 / 127.0)
        return torch.sign(y) * (torch.exp2(torch.abs(y) * 8.0) - 1.0) * (1.0 / 255.0)
    if x.dtype == torch.uint8:
        b = x.reshape(x.shape[0], -1, 3).to(torch.int32)
        u0 = b[..., 0] | ((b[..., 1] & 0xF) << 8)
        u1 = (b[..., 1] >> 4) | (b[..., 2] << 4)
        q = torch.stack([u0, u1], dim=-1).reshape(x.shape[0], -1) - 2048
        if scales is None:
            scales = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
        return q.to(torch.float32) * (scales[:, None] * (1.0 / 2047.0))
    return x.to(torch.float32)


def _pack_int12(src: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row peak-scaled linear 12-bit quantisation, two samples per three
    bytes: ``[rows, L]`` (L even) -> ``(bytes [rows, L*3//2], scales [rows])``."""
    rows, L = src.shape
    if L % 2:
        raise ValueError(f"int12 packing needs an even sample count, got {L}")
    peak = np.abs(src).max(axis=1)
    peak = np.where(peak > 0, peak, 1.0).astype(np.float32)
    q = np.clip(np.rint(src * (2047.0 / peak[:, None])), -2047, 2047).astype(np.int32)
    u = (q + 2048).reshape(rows, L // 2, 2)
    b = np.empty((rows, L // 2, 3), np.uint8)
    b[..., 0] = u[..., 0] & 0xFF
    b[..., 1] = (u[..., 0] >> 8) | ((u[..., 1] & 0xF) << 4)
    b[..., 2] = u[..., 1] >> 4
    return b.reshape(rows, -1), peak


class SongMixer:
    """Batched full-song gain computation + reference-parity mixing.

    :param model: a gain model (``tpumix_torch.models``) holding its
        weights; it is moved to ``device`` in ``channels_last`` eval mode.
        ``model_cfg.features`` says what it reads: ``"db_stft"`` (four
        stems' dB STFTs, one gain each) or ``"vggish"`` (any number of
        tracks, ``(a_L, a_R)`` each; :meth:`mix_song_smooth_device` only).
    :param transfer_dtype: host -> device wire format of the stems for the
        gain computation — ``"float32"``, ``"int16"`` (PCM16, lossless for
        16-bit sources), ``"int12"`` (per-row peak-scaled, packed) or
        ``"mulaw8"`` (opt-in, measurable gain deviation).  The mixed audio is
        always the original waveform scaled by the gains.
    :param device: ``None`` = ``cuda`` (raises without a card); ``"cpu"``
        runs the kernels' plain versions.
    :param mesh: with ``chunk_axis``, a ``tpumix_torch.parallel.Mesh`` whose
        ranks split each segment's chunks along that axis: every rank runs the
        same calls on the same song (SPMD), computes its contiguous share of
        each segment and receives the others' gains, so every method returns
        the full result on every rank.
    """

    def __init__(self, model: torch.nn.Module, model_cfg: ModelConfig,
                 mix_cfg: Optional[MixConfig] = None, transfer_dtype: str = "float32",
                 device=None, mesh=None, chunk_axis: Optional[str] = None):
        if transfer_dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"unknown transfer_dtype {transfer_dtype!r}; "
                "expected 'float32', 'int16', 'int12', or 'mulaw8'"
            )
        self.device = resolve_device(device)
        # full f32 on the card: cuDNN would otherwise run the trunk in TF32
        # (see utils.device.disable_tf32)
        disable_tf32()
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.model_cfg = model_cfg
        if model_cfg.features not in ("db_stft", "vggish"):
            raise ValueError(f"unknown model features {model_cfg.features!r}")
        # a model of tracks reads VGGish examples framed across chunk edges,
        # so each segment's slice carries the frontend's halo
        self._tracks = model_cfg.features == "vggish"
        self._halo = vggish.HALO if self._tracks else (0, 0)
        self.mix_cfg = mix_cfg or MixConfig(chunk_length_s=model_cfg.chunk_length_s)
        self.frontend = model_cfg.frontend()
        self.frontend.resolved_implementation()  # raise early on an unknown name
        self.chunk_samples = self.frontend.chunk_samples(model_cfg.chunk_length_s)
        self.transfer_dtype = transfer_dtype
        self._chunk_axis = (mesh.axis(chunk_axis)
                            if mesh is not None and chunk_axis is not None else None)
        self._packer: Optional[ThreadPoolExecutor] = None

    # --- device path ---------------------------------------------------------

    @torch.inference_mode()
    def _gains_fn(self, flat: torch.Tensor, n_chunks: int,
                  scales: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``[num_stems, n_chunks*C]`` (possibly quantised) on the device ->
        ``[n_chunks, num_stems]`` gains.  Chunking happens on the device so
        the transfer is one contiguous buffer.  A model of tracks takes
        ``[tracks, halo + n_chunks*C + halo]`` and gives ``[n_chunks, tracks,
        2]``."""
        num_stems = flat.shape[0]
        x = _dequantize_on_device(flat, scales)
        axis = self._chunk_axis
        if self._tracks:
            feats = vggish.segment_examples(x, n_chunks)  # [N, tracks, 96, 64]
            if axis is not None:
                feats = feats[axis.rows(n_chunks)]
        else:
            x = x.reshape(num_stems, n_chunks, self.chunk_samples).transpose(0, 1)  # [N, S, C]
            if axis is not None:
                x = x[axis.rows(n_chunks)]  # this rank's share of the chunks
            feats_tm = spectrogram_features_tm(x, self.frontend)  # [N, S, T, F]
            # [N, S, F, T] as a channels_last view: physical [N, F, T, S]
            feats = feats_tm.permute(0, 3, 2, 1).contiguous().permute(0, 3, 1, 2)
        gains = self.model.gains(feats)
        if axis is None or axis.size == 1:
            return gains
        # gather: each rank fills its rows of a zero buffer, and a sum over
        # the ranks (the one collective gloo also has for CUDA tensors) adds
        # zeros to every other row, exactly
        full = gains.new_zeros((n_chunks, *gains.shape[1:]))
        full[axis.rows(n_chunks)] = gains
        return axis.all_reduce(full)

    def _segment_len(self) -> int:
        """Chunks per segment, rounded up so a sharded chunk axis divides it
        (tpumix/infer/mixer.py:314-321)."""
        seg = self.mix_cfg.max_chunks or SEGMENT_CHUNKS
        if self._chunk_axis is not None:
            seg = -(-seg // self._chunk_axis.size) * self._chunk_axis.size
        return seg

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        """Host staging buffer, page-locked when the card is the target so
        the copy runs asynchronously.  The copy must be issued from this
        tensor (not a ``from_numpy`` alias) so the pinned block is not reused
        before the copy ends."""
        return torch.empty(shape, dtype=getattr(torch, np.dtype(dtype).name),
                           pin_memory=self.device.type == "cuda")

    def song_gains_async(self, stems: np.ndarray):
        """Dispatch the whole song's gain computation without waiting for
        the device; collect with :meth:`collect_gains`.  Host packing of
        segment k+1 overlaps the transfer and compute of segment k."""
        if self._tracks:
            raise ValueError(f"{self.model_cfg.name} mixes through mix_song_smooth_device only")
        num_stems, S = stems.shape
        C = self.chunk_samples
        n_gains = S // C - 1
        if n_gains <= 0:
            return []
        seg = self._segment_len()

        int16_in = stems.dtype == np.int16
        out_dtype = _WIRE_DTYPES[self.transfer_dtype]
        if out_dtype == np.float32 and int16_in:
            out_dtype = np.int16  # decode-free PCM16 fast path

        def pack(lo: int, n: int):
            """Segment [lo, lo+n) -> (wire buffer, optional scales)."""
            with span("mixer.pack"):
                return _pack(lo, n)

        def _pack(lo: int, n: int):
            src = stems[:, lo * C : (lo + n) * C]
            if out_dtype == np.uint8:
                wire, scales = _pack_int12(
                    src.astype(np.float32) * (1.0 / 32768.0) if int16_in else src
                )
                buf = self._host_buffer((num_stems, seg * C * 3 // 2), np.uint8)
                flat = buf.numpy()
                flat[:, : n * C * 3 // 2] = wire
                if n < seg:  # pad with exact packed zeros (bias pattern)
                    flat[:, n * C * 3 // 2 :].reshape(num_stems, -1, 3)[:] = (0, 8, 128)
                return buf, scales
            buf = self._host_buffer((num_stems, seg * C), out_dtype)
            flat = buf.numpy()
            if n < seg:
                flat[:, n * C :] = 0
            if out_dtype == np.int8:
                if int16_in:
                    pcm = src.astype(np.int32)
                else:
                    pcm = np.clip(np.rint(src * 32768.0), -32768, 32767).astype(np.int32)
                flat[:, : n * C] = _mulaw_lut()[pcm + 32768]
            elif out_dtype == np.int16 and not int16_in:
                flat[:, : n * C] = np.clip(np.rint(src * 32768.0), -32768, 32767)
            else:
                flat[:, : n * C] = src
            return buf, None

        def dispatch(packed, n: int):
            count("mixer.chunks_real", n)
            count("mixer.chunks_run", seg)
            with span("mixer.dispatch"):
                buf, scales = packed
                wire = buf.to(self.device, non_blocking=True)
                sc = None if scales is None else torch.from_numpy(scales).to(self.device)
                return (self._gains_fn(wire, seg, sc), n)

        segs = [(lo, min(seg, n_gains - lo)) for lo in range(0, n_gains, seg)]
        if len(segs) == 1:
            return [dispatch(pack(*segs[0]), segs[0][1])]
        if self._packer is None:
            self._packer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tpumix-pack")
        window = 2
        futures = []
        pending = deque(
            self._packer.submit(carry(pack), *segs[i]) for i in range(min(window, len(segs)))
        )
        for i, (lo, n) in enumerate(segs):
            packed = pending.popleft().result()
            if i + window < len(segs):
                pending.append(self._packer.submit(carry(pack), *segs[i + window]))
            futures.append(dispatch(packed, n))
        return futures

    @staticmethod
    def collect_gains(futures) -> np.ndarray:
        """Wait for a :meth:`song_gains_async` handle -> ``[n_gains, 4]``."""
        if not futures:
            return np.zeros((0, len(STEMS)), dtype=np.float32)
        with span("mixer.collect"):
            return np.concatenate([g[:n].cpu().numpy() for g, n in futures], axis=0)

    def song_gains(self, stems: np.ndarray) -> np.ndarray:
        """Per-chunk raw gains for a whole song.

        :param stems: ``[4, S]`` mono stem waveforms (bass, drums, vocals,
            other).
        :return: ``[num_chunks - 1, 4]`` scalar gains (dB-domain model
            scalars)."""
        return self.collect_gains(self.song_gains_async(stems))

    # --- fully device-resident mixing ---------------------------------------

    def song_gains_device(self, stems_dev: torch.Tensor):
        """Per-chunk gains for stems already on the device (no packing, no
        wire quantisation): ``song_gains_async``-style ``(gains, n)`` list.
        Each segment's input is :meth:`segment_input`."""
        num_stems, S = stems_dev.shape
        C = self.chunk_samples
        n_gains = S // C - 1
        if n_gains <= 0:
            return []
        seg = self._segment_len()
        stems_dev = stems_dev.to(self.device, torch.float32)
        futures = []
        for lo in range(0, n_gains, seg):
            n = min(seg, n_gains - lo)
            count("mixer.chunks_real", n)
            count("mixer.chunks_run", seg)
            futures.append((self._gains_fn(self.segment_input(stems_dev, lo, n, seg), seg), n))
        return futures

    def segment_input(self, stems: torch.Tensor, lo: int, n: int, seg: int) -> torch.Tensor:
        """What ``_gains_fn`` takes for chunks ``[lo, lo + n)`` of ``stems
        [tracks, S]`` in a ``seg``-chunk segment: their samples with the
        model's halo either side (``vggish.HALO``; none for the dB STFT),
        zeros past the song's ends and for the ``seg - n`` chunks after."""
        C, S = self.chunk_samples, stems.shape[-1]
        left, right = self._halo
        a, b = lo * C - left, min((lo + n) * C + right, S)
        part = stems[:, max(a, 0):b]
        pad_left = max(-a, 0)
        pad_right = left + seg * C + right - pad_left - part.shape[-1]
        if pad_left or pad_right:
            part = torch.nn.functional.pad(part, (pad_left, pad_right))
        return part

    def _savgol_params(self, num_chunks: int, n_gains: int):
        """Window policy shared by both epilogues: the curve length is the
        hard cap and the polyorder bends to the window (mixer.py:491-500)."""
        win = self.mix_cfg.savgol_window or default_savgol_window(num_chunks)
        win = max(min(win, n_gains if n_gains % 2 else n_gains - 1), 1)
        return win, min(self.mix_cfg.savgol_polyorder, win - 1)

    @torch.inference_mode()
    def mix_song_smooth_device(self, stems):
        """``mix_song_smooth`` with gains, smoothing, mask stretch, scaling,
        mixdown and peak normalisation all on the device.

        :param stems: ``[4, S]`` mono stems (tensor or array) or a track dict;
            for a model of tracks ``[N, S]`` or a dict of any N track names.
        :return: ``(mixed_tracks [4, S], mixed [S] peak-normalised,
            smooth_amp_curves [4, n_gains])`` — device tensors; for a model
            of tracks ``(mixed_tracks [N, 2, S], mixed [2, S],
            smoothed (a_L, a_R) [N, 2, n_gains])``."""
        with span("mixer.song"):
            if isinstance(stems, dict):
                names = list(stems) if self._tracks else STEMS
                stems = np.stack([self._mono(stems[t]) for t in names])
            with span("mixer.stage"):
                stems_dev = torch.as_tensor(stems, dtype=torch.float32).to(self.device)
            if self._tracks:
                return self._mix_tracks_stereo(stems_dev)
            num_stems, S = stems_dev.shape
            num_chunks = S // self.chunk_samples
            n_gains = num_chunks - 1
            if n_gains <= 0:
                # shorter than two chunks: stems pass through, mixdown normalised
                mixed = stems_dev.sum(dim=0)
                peak = mixed.abs().max()
                mixed = torch.where(peak > 0, mixed / peak, mixed)
                return stems_dev, mixed, torch.zeros((num_stems, 0), device=self.device)
            gains = torch.cat([g[:n] for g, n in self.song_gains_device(stems_dev)], dim=0)
            curves = torch.pow(10.0, 0.5 * gains).T  # [num_stems, n_gains]
            if n_gains >= 3:
                win, poly = self._savgol_params(num_chunks, n_gains)
                smoothed = savgol_smooth_torch(curves, win, poly)
            else:
                smoothed = curves
            mixed_tracks = stems_dev * interpolate_mask(smoothed, S)
            mixed = mixed_tracks.sum(dim=0)
            peak = mixed.abs().max()
            mixed = torch.where(peak > 0, mixed / peak, mixed)
            return mixed_tracks, mixed, smoothed

    def _mix_tracks_stereo(self, tracks: torch.Tensor):
        """The stereo epilogue of a model of tracks: ``(a_L, a_R)`` of every
        track smoothed as ``2N`` curves, each track scaled into both
        channels, summed and peak-normalised."""
        N, S = tracks.shape
        num_chunks = S // self.chunk_samples
        n_gains = num_chunks - 1
        if n_gains <= 0:
            # shorter than two chunks: each track in both channels, normalised
            mixed_tracks = tracks[:, None, :].expand(N, 2, S)
            curves = torch.zeros((N, 2, 0), device=self.device)
        else:
            amps = torch.cat([g[:n] for g, n in self.song_gains_device(tracks)], dim=0)
            curves = amps.permute(1, 2, 0).reshape(2 * N, n_gains)  # rows (t, L), (t, R)
            if n_gains >= 3:
                win, poly = self._savgol_params(num_chunks, n_gains)
                curves = savgol_smooth_torch(curves, win, poly)
            mixed_tracks = tracks[:, None, :] * interpolate_mask(curves, S).view(N, 2, S)
            curves = curves.view(N, 2, n_gains)
        mixed = mixed_tracks.sum(dim=0)
        peak = mixed.abs().max()
        mixed = torch.where(peak > 0, mixed / peak, mixed)
        return mixed_tracks, mixed, curves

    def mix_song_device(self, stems) -> torch.Tensor:
        """Device-resident :meth:`mix_song`: the peak-normalised mix ``[S]``."""
        _, mixed, _ = self.mix_song_smooth_device(stems)
        return mixed

    # --- host epilogue -------------------------------------------------------

    @staticmethod
    def _mono(x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        return x.mean(axis=0) if x.ndim == 2 else x

    def mix_song_smooth(self, loaded_tracks: Dict[str, np.ndarray]):
        """Reference-parity API (inference_utils.py:105-145):
        ``(mixed_tracks, raw_gains, smooth_gains)`` dicts keyed by stem;
        ``loaded_tracks`` values are ``[channels, S]`` or ``[S]``."""
        with span("mixer.song"):
            with span("mixer.downmix"):
                stem_mono = np.stack([self._mono(loaded_tracks[t]) for t in STEMS])
            gains = self.song_gains(stem_mono)
            return self._apply_gains(loaded_tracks, stem_mono.shape[1], gains)

    def mix_songs_smooth(self, track_dicts):
        """Dispatch every song's device work first, then run the host
        epilogues in order; a list of ``mix_song_smooth`` results."""
        monos = [np.stack([self._mono(tr[t]) for t in STEMS]) for tr in track_dicts]
        handles = [self.song_gains_async(m) for m in monos]
        return [
            self._apply_gains(tracks, mono.shape[1], self.collect_gains(h))
            for tracks, mono, h in zip(track_dicts, monos, handles)
        ]

    def _apply_gains(self, loaded_tracks: Dict[str, np.ndarray], S: int, gains: np.ndarray):
        """Host epilogue: dB -> amplitude, Savitzky-Golay, mask stretch,
        per-stem scaling."""
        with span("mixer.epilogue"):
            amp_gains = 10.0 ** (0.5 * gains)  # float32: overflows as the reference does
            num_chunks = S // self.chunk_samples
            raw_gains = {t: list(map(float, amp_gains[:, i])) for i, t in enumerate(STEMS)}
            if amp_gains.shape[0] == 0:
                mixed = {t: np.asarray(loaded_tracks[t], dtype=np.float32) for t in STEMS}
                return mixed, raw_gains, {t: [] for t in STEMS}

            smooth_gains: Dict[str, list] = {}
            mixed_tracks: Dict[str, np.ndarray] = {}
            n_gains = amp_gains.shape[0]
            for i, t in enumerate(STEMS):
                curve = amp_gains[:, i]
                if n_gains >= 3:
                    win, poly = self._savgol_params(num_chunks, n_gains)
                    smoothed = savgol_smooth(curve, win, poly)
                else:
                    smoothed = curve.astype(np.float64)
                smooth_gains[t] = list(map(float, smoothed))
                track = np.asarray(loaded_tracks[t], dtype=np.float32)
                mask = interpolate_mask_np(smoothed, track.shape[-1]).astype(np.float32)
                mixed_tracks[t] = track * mask
            return mixed_tracks, raw_gains, smooth_gains

    def mix_song_raw(self, loaded_tracks: Dict[str, np.ndarray]):
        """Raw-gain mixing (reference ``mix_song``, inference_utils.py:44-102):
        window w is mixed with its own unsmoothed gains; the last chunk stays
        silent.  Returns ``(mixed_song [S], mask_history)``."""
        stem_mono = np.stack([self._mono(loaded_tracks[t]) for t in STEMS])
        gains = self.song_gains(stem_mono)
        amp = (10.0 ** (0.5 * gains)).astype(np.float32)
        C = self.chunk_samples
        S = stem_mono.shape[1]
        mixed = np.zeros(S, dtype=np.float32)
        n = amp.shape[0]
        region = stem_mono[:, : n * C].reshape(len(STEMS), n, C)
        mixed[: n * C] = np.einsum("snc,ns->nc", region, amp).reshape(-1)
        mask_history = {t: list(map(float, amp[:, i])) for i, t in enumerate(STEMS)}
        return mixed, mask_history

    def mix_song(self, loaded_tracks: Dict[str, np.ndarray]) -> np.ndarray:
        """Smooth-mix, sum the stems, peak-normalise."""
        mixed_tracks, _, _ = self.mix_song_smooth(loaded_tracks)
        total = sum(np.asarray(v, dtype=np.float32) for v in mixed_tracks.values())
        peak = np.max(np.abs(total))
        if peak > 0:
            total = total / peak
        return total


# shim mixers keyed on (model, chunk/hop config, device) identity: a fresh
# SongMixer per call would pack the model's weights for the card anew on
# every song of a catalogue loop.  A strong reference to the model is held
# WITH the cache entry so the id() key cannot go stale; the cache is small
# and FIFO-bounded (tpumix/infer/mixer.py:555-581).
_SHIM_MIXERS: Dict[tuple, tuple] = {}
_SHIM_MIXERS_MAX = 8


def mix_song_smooth(dataset, model, loaded_tracks, chunk_length=1, sr=44100, *,
                    hop_length=512, device=None):
    """Drop-in signature shim for the reference free function
    (inference_utils.py:105): ``(mixed_tracks, raw_gains, smooth_gains)``.
    ``dataset`` and ``sr`` are accepted and unused, as in the JAX package.
    Prefer :class:`SongMixer`; this shim reuses one mixer per (model, chunk /
    hop config, device).  ``device``: ``None`` = ``cuda``."""
    key = (id(model), float(chunk_length), int(hop_length), str(resolve_device(device)))
    entry = _SHIM_MIXERS.get(key)
    if entry is None:
        cfg = ModelConfig(name="compat", chunk_length_s=chunk_length, hop_length=hop_length)
        while len(_SHIM_MIXERS) >= _SHIM_MIXERS_MAX:
            _SHIM_MIXERS.pop(next(iter(_SHIM_MIXERS)))
        # (mixer, model): the latter pins the id() alive
        entry = (SongMixer(model, cfg, device=device), model)
        _SHIM_MIXERS[key] = entry
    return entry[0].mix_song_smooth(loaded_tracks)
