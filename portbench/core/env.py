"""The run's environment, set before torch or the program is imported.

Build and kernel caches live at fixed paths inside the checkout, so that
only a checkout's first run builds (the program's own nvcc builds go to
``tpumix_torch/_build/``, also inside it).  JAX is kept out of any library
that would load it by itself, and the host's math libraries get few threads:
one process drives the card.
"""

from __future__ import annotations

import os

CACHE = ".portbench_cache"


def prepare(root: str) -> float:
    """Set the environment; return this process's start on the wall clock."""
    from portbench.core.harness import process_start

    started = process_start()
    cache = os.path.join(root, CACHE)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    return started
