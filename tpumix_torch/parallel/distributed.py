"""Multi-process bring-up over ``torch.distributed`` and the host-local batch
path (tpumix/parallel/distributed.py).

* :func:`initialize`: idempotent ``init_process_group``.  Explicit arguments
  first, then torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``), then a single-process no-op.
  The backend is explicit: ``nccl`` for a CUDA device, ``gloo`` for the CPU,
  and ``gloo`` on CUDA when asked for by name (NCCL refuses two ranks on one
  card).
* :func:`process_count` / :func:`process_index`: safe uninitialised (one
  process).
* :func:`shard_range`: contiguous ``[lo, hi)`` work split for this process.
* :func:`global_batch`: each rank keeps its host-local shard of a global batch
  on its own device, the data-parallel form of
  ``jax.make_array_from_process_local_data``.

A rank's device is ``cuda:LOCAL_RANK`` unless the caller names one.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tpumix_torch.utils.device import resolve_device

BACKENDS = ("nccl", "gloo")


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` if given, else ``cuda:LOCAL_RANK`` (0
    outside torchrun); raises without a card, like every entry point."""
    if device is not None:
        return resolve_device(device)
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")


def resolve_backend(backend: Optional[str], device) -> str:
    """``backend`` as given, else the one for ``device``'s type: ``nccl`` on
    CUDA, ``gloo`` on the CPU.  NCCL has no CPU path."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {device}")
    return backend


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None, device=None,
               timeout_s: float = 600.0) -> bool:
    """Join a process group if (and only if) one is configured; returns True
    when a group is active.

    Resolution order: explicit ``init_method`` (with ``world_size`` and
    ``rank``; ``file://`` or ``tcp://host:port``) > torchrun's environment
    (``WORLD_SIZE`` set: ``env://``) > single-process no-op.  ``backend``:
    see :func:`resolve_backend`, for ``device`` (:func:`local_device`).  Safe
    to call more than once: a later call returns the state of the group the
    first one made."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    elif world_size is None or rank is None:
        raise ValueError("initialize(init_method=...) needs world_size and rank")
    device = local_device(device)
    backend = resolve_backend(backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Leave the process group, if one is active."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shard_range(n_items: int, index: Optional[int] = None, count: Optional[int] = None) -> Tuple[int, int]:
    """Contiguous ``[lo, hi)`` slice of ``n_items`` owned by this process.

    Remainder items go to the lowest-indexed processes, so every process gets
    either ``ceil`` or ``floor`` of the even share and the union is exact.
    """
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    if not 0 <= index < count:
        raise ValueError(f"process index {index} outside [0, {count})")
    base, extra = divmod(n_items, count)
    lo = index * base + min(index, extra)
    hi = lo + base + (1 if index < extra else 0)
    return lo, hi


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def global_batch(local_batch, device=None):
    """This process's rows of a global batch (a tuple, list or dict of arrays
    holding ``global_batch_size / process_count`` items each) as tensors on
    this rank's device (:func:`local_device`).  Together the ranks hold the
    global batch in rank order, which is what the steps built with a mesh
    reduce over."""
    device = local_device(device)
    return _tree_map(lambda x: torch.as_tensor(x).to(device), local_batch)
