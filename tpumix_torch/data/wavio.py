"""WAV file I/O (tpumix/data/wavio.py).

* this module: a RIFF/WAVE parser/writer in numpy: PCM 16/24/32-bit and IEEE
  float32/64, any channel count, chunk skipping, partial (seek) reads and
  metadata-only probes;
* ``tpumix_torch/data/_native.py``: the C++ reader
  (tpumix_torch/csrc/tpumixio.cpp), which ``read_mono`` takes when it is
  built; this module is its fallback (``TPUMIX_NO_NATIVE=1`` selects it).

API mirrors the soundfile subset the reference touches: ``read``, ``write``,
``info``.  Arrays are ``[samples, channels]`` float, or 1-D for mono unless
``always_2d``.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional, Tuple

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclasses.dataclass(frozen=True)
class WavInfo:
    samplerate: int
    channels: int
    frames: int
    format: str  # "PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE"
    data_offset: int  # byte offset of sample data in the file
    bytes_per_frame: int

    @property
    def duration(self) -> float:
        return self.frames / self.samplerate


def _parse_header(f) -> WavInfo:
    riff, size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    data_offset = None
    data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, csize = struct.unpack("<4sI", hdr)
        if cid == b"fmt ":
            fmt = f.read(csize)
            if csize % 2:
                f.read(1)
        elif cid == b"data":
            data_offset = f.tell()
            data_size = csize
            # don't read the payload; skip past (payload may be huge)
            f.seek(csize + (csize % 2), os.SEEK_CUR)
        else:
            f.seek(csize + (csize % 2), os.SEEK_CUR)
    if fmt is None or data_offset is None:
        raise ValueError("missing fmt/data chunk")

    (audio_format, channels, samplerate, _byte_rate, block_align, bits) = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == _WAVE_FORMAT_EXTENSIBLE:
        # real format lives in the SubFormat GUID's first two bytes
        if len(fmt) >= 40:
            audio_format = struct.unpack("<H", fmt[24:26])[0]
        else:
            raise ValueError("malformed WAVE_FORMAT_EXTENSIBLE fmt chunk")

    if audio_format == _WAVE_FORMAT_PCM:
        fmt_name = {16: "PCM_16", 24: "PCM_24", 32: "PCM_32"}.get(bits)
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        fmt_name = {32: "FLOAT", 64: "DOUBLE"}.get(bits)
    else:
        fmt_name = None
    if fmt_name is None:
        raise ValueError(f"unsupported WAV format: code={audio_format} bits={bits}")

    if channels <= 0:
        raise ValueError("non-positive channel count in fmt chunk")
    implied_bpf = channels * bits // 8
    # reject a block_align that disagrees with the format-implied frame size
    # (same contract as the native parser, native/tpumixio.cpp): trusting it
    # would make frames/partial-read seeks wrong by up to bits*channels/8x
    if block_align and block_align != implied_bpf:
        raise ValueError(
            f"block_align {block_align} contradicts format-implied frame size "
            f"{implied_bpf} ({channels} ch x {bits} bit)"
        )
    bytes_per_frame = block_align or implied_bpf
    if bytes_per_frame <= 0:
        raise ValueError("non-positive frame size in fmt chunk")
    # data_size can exceed the true payload in malformed files; clamp by file size
    data_size = min(data_size, _stream_size(f) - data_offset)
    frames = data_size // bytes_per_frame
    return WavInfo(samplerate, channels, frames, fmt_name, data_offset, bytes_per_frame)


def _stream_size(f) -> int:
    """Total byte size of an open binary stream (file or BytesIO)."""
    try:
        return os.fstat(f.fileno()).st_size
    except (AttributeError, OSError):
        pos = f.tell()
        size = f.seek(0, os.SEEK_END)
        f.seek(pos)
        return size


def _open(path_or_file):
    """(stream, needs_close) for a path or an open seekable binary stream
    (e.g. io.BytesIO — the HTTP service decodes request bodies in memory)."""
    if hasattr(path_or_file, "read"):
        path_or_file.seek(0)
        return path_or_file, False
    return open(path_or_file, "rb"), True


def info(path) -> WavInfo:
    """Metadata-only probe (the reference's ``sf.info`` usage,
    data/dataset.py:70).  Accepts a path or a seekable binary stream."""
    f, needs_close = _open(path)
    try:
        return _parse_header(f)
    finally:
        if needs_close:
            f.close()


def read_mono(path: str, start: int = 0, count: Optional[int] = None) -> np.ndarray:
    """Fused decode + stereo->mono downmix (channel mean) of ``count`` frames,
    the dataset's hot per-chunk read: through the C++ reader when it is
    built, numpy otherwise."""
    if count is None:
        count = info(path).frames - start
    from tpumix_torch.data import _native

    out = _native.read_mono_f32(path, start, count)
    if out is not None:
        return out
    audio, _ = read(path, start=start, stop=start + count, always_2d=True)
    return audio.mean(axis=1).astype(np.float32)


def _decode(raw: bytes, fmt: str, channels: int, dtype: str) -> np.ndarray:
    if dtype == "int16":
        # decode-free fast path: raw PCM16 samples (feeds the SongMixer's
        # int16 device-dequantisation path with zero host float conversion)
        if fmt != "PCM_16":
            raise ValueError(f"dtype='int16' requires a PCM_16 file, got {fmt}")
        x = np.frombuffer(raw, dtype="<i2")
        if channels > 1:
            x = x.reshape(-1, channels)
        return x
    if fmt == "PCM_16":
        x = np.frombuffer(raw, dtype="<i2").astype(dtype) / 32768.0
    elif fmt == "PCM_24":
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        # sign-extend 24-bit little-endian into int32
        x32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x32 = (x32 ^ 0x800000) - 0x800000
        x = x32.astype(dtype) / 8388608.0
    elif fmt == "PCM_32":
        x = np.frombuffer(raw, dtype="<i4").astype(dtype) / 2147483648.0
    elif fmt == "FLOAT":
        x = np.frombuffer(raw, dtype="<f4").astype(dtype)
    elif fmt == "DOUBLE":
        x = np.frombuffer(raw, dtype="<f8").astype(dtype)
    else:  # pragma: no cover
        raise ValueError(fmt)
    if channels > 1:
        x = x.reshape(-1, channels)
    return x


def read(
    path: str,
    start: int = 0,
    stop: Optional[int] = None,
    dtype: str = "float32",
    always_2d: bool = False,
) -> Tuple[np.ndarray, int]:
    """Read samples; returns ``(audio, samplerate)``.

    ``start``/``stop`` are frame indices (soundfile ``sf.read(start=, stop=)``
    parity — the reference's chunked reads, data/dataset.py:194).  Mono files
    yield 1-D arrays unless ``always_2d``.  ``path`` may be a filesystem path
    or a seekable binary stream (io.BytesIO).
    """
    meta = info(path)
    start = max(0, min(start, meta.frames))
    stop = meta.frames if stop is None else max(start, min(stop, meta.frames))
    count = stop - start
    f, needs_close = _open(path)
    try:
        f.seek(meta.data_offset + start * meta.bytes_per_frame)
        raw = f.read(count * meta.bytes_per_frame)
    finally:
        if needs_close:
            f.close()
    x = _decode(raw, meta.format, meta.channels, dtype)
    if always_2d and x.ndim == 1:
        x = x[:, None]
    return x, meta.samplerate


def write(path: str, data: np.ndarray, samplerate: int, subtype: str = "FLOAT") -> None:
    """Write ``[samples]`` or ``[samples, channels]`` audio.

    ``subtype``: "PCM_16", "PCM_24", "PCM_32", "FLOAT" (default, lossless for
    the float32 pipelines in this framework).
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    frames, channels = data.shape

    if subtype != "FLOAT" and not np.all(np.isfinite(data)):
        # NaN passes straight through np.clip and the int cast turns it into
        # INT_MIN full-scale noise; sanitise to silence / clipped full scale
        data = np.nan_to_num(data, nan=0.0, posinf=1.0, neginf=-1.0)

    if subtype == "PCM_16":
        payload = np.clip(np.round(data * 32768.0), -32768, 32767).astype("<i2").tobytes()
        bits, code = 16, _WAVE_FORMAT_PCM
    elif subtype == "PCM_24":
        x32 = np.clip(np.round(data * 8388608.0), -8388608, 8388607).astype(np.int32)
        flat = x32.reshape(-1)
        b = np.empty((flat.size, 3), dtype=np.uint8)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        payload = b.tobytes()
        bits, code = 24, _WAVE_FORMAT_PCM
    elif subtype == "PCM_32":
        # float64 intermediate: float32 cannot represent 2147483647, so a
        # full-scale +1.0 sample would clip to 2**31 and overflow the cast
        payload = (
            np.clip(np.round(data.astype(np.float64) * 2147483648.0), -2147483648, 2147483647)
            .astype("<i4")
            .tobytes()
        )
        bits, code = 32, _WAVE_FORMAT_PCM
    elif subtype == "FLOAT":
        payload = data.astype("<f4").tobytes()
        bits, code = 32, _WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    block_align = channels * bits // 8
    byte_rate = samplerate * block_align
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, code, channels, samplerate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
        if len(payload) % 2:
            f.write(b"\x00")


def resample_poly(audio: np.ndarray, sr_in: int, sr_out: int, axis: int = 0) -> np.ndarray:
    """Polyphase resampling (librosa.load(sr=...) replacement for off-rate
    files; reference loads everything at 44100, dataset_utils.py:65)."""
    if sr_in == sr_out:
        return audio
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(sr_in, sr_out)
    return _rp(audio, sr_out // g, sr_in // g, axis=axis)
