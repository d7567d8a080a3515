"""Build and load the port's native libraries: the CUDA kernels and the WAV
reader.

Each ``tpumix_torch/csrc/<name>.cu`` compiles with nvcc, and the host-only
``tpumix_torch/csrc/<name>.cpp`` (the WAV reader) with g++, into a shared
library with a plain C interface, at first use, into ``tpumix_torch/_build/``
under a name keyed on a hash of the source, the shared headers and the flags,
and loads with ctypes.  A build uses only the sources in the package.
``build()`` compiles several sources at once, one compiler process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the JAX package's native/Makefile flags for the host library
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall", "-Wextra")
# libraries built from a .cpp with g++ (no CUDA)
HOST_SOURCES = ("tpumixio",)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point and argument types of each library: pointers and the stream
# as c_void_p (ctypes would otherwise pass them as 32-bit ints)
SIGNATURES = {
    "stft_dif": ("stft_dif_launch",
                 (_P, _P, _P, _I, _I, ctypes.c_longlong, _I, ctypes.c_float, ctypes.c_double, _P)),
    "conv_block": ("conv_block_launch",
                   (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "stft_basis": ("stft_basis_launch",
                   (_P, _P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _I, _I, _I, ctypes.c_float,
                    ctypes.c_double, _P)),
}
# further C entries of a library: shape queries it answers, and launches that
# exist for measurement only
EXTRA_ENTRIES = {
    "conv_block": (
        ("conv_block_route", (_I, _I, _I, _I, _I, _I, _I)),
        ("conv_block_undrained_launch",
         (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    ),
    "stft_basis": (("stft_basis_route", (_I,)),),
    "stft_dif": (("stft_dif_stages_launch",
                  (_P, _P, _P, _I, _I, ctypes.c_longlong, _I, ctypes.c_float, ctypes.c_double,
                   _I, _P)),),
}


_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
_READ = (ctypes.c_char_p, _I64, _I64, _F32P)
# the WAV reader's C entries, (name, argument types, result type), as the JAX
# package declares them (tpumix/data/_native.py:55-84)
HOST_ENTRIES = {
    "tpumixio": (
        ("tpumixio_info", (ctypes.c_char_p, _I32P, _I32P, ctypes.POINTER(_I64), _I32P), _I),
        ("tpumixio_read_f32", _READ, _I64),
        ("tpumixio_read_mono_f32", _READ, _I64),
        ("tpumixio_read_chunks_mono_f32", _READ, _I64),
        ("tpumixio_write",
         (ctypes.c_char_p, _F32P, _I64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32), _I),
    ),
}


def gxx_path() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("g++ not found: set CXX or put g++ on PATH")
    return found


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # PyTorch's own lookup: CUDA_HOME / CUDA_PATH, then the toolkit's default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> str:
    """Keyed on the source, every shared header (``csrc/*.cuh``; none for a
    host library) and the flags."""
    if name in HOST_SOURCES:
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        sources = [f"{name}.cpp"]
    else:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        sources = [f"{name}.cu", *sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))]
    for fname in sources:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every listed source that has no up-to-date library, all
    compiler processes started together; raise with the compiler output on
    failure.  Returns ``{name: library path}``.  The compiler's report (for a
    kernel, ptxas's registers, shared memory and spills) lands beside each
    library as ``.log``."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        if name in HOST_SOURCES:  # the compiler is found before a temporary file exists
            head = [gxx_path(), *GXX_FLAGS]
            src = os.path.join(CSRC, f"{name}.cpp")
        else:
            head = [nvcc_path(), *NVCC_FLAGS]
            src = os.path.join(CSRC, f"{name}.cu")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [*head, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        with open(path[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{os.path.basename(proc.args[0])} failed for {name} "
                            f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: library_path(name) for name in names}


_LOAD_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """Build if needed, load, and declare the entry points' signatures.  Only
    a miss takes the lock: a thread that calls during the first build (the
    HTTP service runs each request on its own thread) waits for it instead
    of compiling again, and a loaded library is read without the lock."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        if name not in _LOADED:
            lib = ctypes.CDLL(build((name,))[name])
            entries = HOST_ENTRIES.get(name) or [
                (*entry, _I) for entry in (SIGNATURES[name], *EXTRA_ENTRIES.get(name, ()))]
            for fn_name, argtypes, restype in entries:
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _LOADED[name] = lib
        return _LOADED[name]
