"""Build and load the port's CUDA kernels.

Each ``tpumix_torch/csrc/<name>.cu`` compiles with nvcc into a shared library
with a plain C interface, at first use, into ``tpumix_torch/_build/`` under a
name keyed on a hash of the source, the shared headers and the flags, and
loads with ctypes.  A build
uses only the sources in the package.  ``build()`` compiles several sources
at once, one nvcc process each.
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
    """Keyed on the source, every shared header (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every listed source that has no up-to-date library, all nvcc
    processes started together; raise with the compiler output on failure.
    Returns ``{name: library path}``.  The ptxas report (registers, shared
    memory, spills) lands beside each library as ``.log``."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        nvcc = nvcc_path()  # raises before a temporary file exists
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failures = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        with open(path[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
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
    of running nvcc again, and a loaded library is read without the lock."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        if name not in _LOADED:
            lib = ctypes.CDLL(build((name,))[name])
            for fn_name, argtypes in (SIGNATURES[name], *EXTRA_ENTRIES.get(name, ())):
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LOADED[name] = lib
        return _LOADED[name]
