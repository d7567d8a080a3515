"""ctypes bindings for the port's C++ WAV reader (tpumix_torch/csrc/tpumixio.cpp;
tpumix/data/_native.py).

The library is built with g++ at first use (``tpumix_torch/ops/_build.py``,
into ``tpumix_torch/_build/``).  Every entry point returns None (``write``:
False) when the library is unavailable, so the numpy implementation in
tpumix_torch/data/wavio.py serves as the fallback without a compiler;
``TPUMIX_NO_NATIVE=1`` selects that fallback.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_tried = False

FORMAT_NAMES = {1: "PCM_16", 2: "PCM_24", 3: "PCM_32", 4: "FLOAT", 5: "DOUBLE"}


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded reader, or None if it is disabled or cannot be built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("TPUMIX_NO_NATIVE"):
        return None
    from tpumix_torch.ops import _build

    try:
        _lib = _build.load("tpumixio")
    except (RuntimeError, OSError):  # no compiler, or the build failed
        return None
    return _lib


def _floats(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def info(path: str) -> Optional[Tuple[int, int, int, str]]:
    lib = get_lib()
    if lib is None:
        return None
    sr, ch, frames, fmt = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int32()
    rc = lib.tpumixio_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                           ctypes.byref(frames), ctypes.byref(fmt))
    if rc != 0:
        return None
    return sr.value, ch.value, frames.value, FORMAT_NAMES.get(fmt.value, "?")


def read_f32(path: str, start: int, count: int, channels: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((count, channels), dtype=np.float32)
    got = lib.tpumixio_read_f32(path.encode(), start, count, _floats(out))
    if got < 0:
        return None
    return out[:got]


def read_mono_f32(path: str, start: int, count: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(count, dtype=np.float32)
    got = lib.tpumixio_read_mono_f32(path.encode(), start, count, _floats(out))
    if got < 0:
        return None
    return out[:got]


def read_chunks_mono_f32(path: str, chunk_samples: int, num_chunks: int) -> Optional[np.ndarray]:
    """Whole-song fused decode+downmix+chunk: ``[num_chunks, chunk_samples]``,
    the tail zero-padded."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((num_chunks, chunk_samples), dtype=np.float32)
    got = lib.tpumixio_read_chunks_mono_f32(path.encode(), chunk_samples, num_chunks,
                                            _floats(out))
    if got < 0:
        return None
    return out


def write(path: str, data: np.ndarray, samplerate: int, subtype: str = "FLOAT") -> bool:
    lib = get_lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    code = {"FLOAT": 4, "PCM_16": 1}.get(subtype)
    if code is None:
        return False
    rc = lib.tpumixio_write(path.encode(), _floats(data), data.shape[0], data.shape[1],
                            samplerate, code)
    return rc == 0
