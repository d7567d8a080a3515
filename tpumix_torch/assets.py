"""Shipped checkpoints, read by path from the JAX package's asset folder.

The ``.npz`` files under ``tpumix/assets/checkpoints`` are data, not code:
the port reads them where they lie and keeps no copy.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from tpumix_torch.models.convert import load_npz

_CHECKPOINTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tpumix", "assets", "checkpoints",
)


def checkpoint_path(name: str = "scalar2sL_synth") -> str:
    """Absolute path of a shipped checkpoint (name without the .npz suffix)."""
    path = os.path.join(_CHECKPOINTS, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no shipped checkpoint {name!r} at {path}")
    return path


def load_checkpoint(name: str = "scalar2sL_synth") -> Dict[str, Any]:
    """Shipped checkpoint -> ``{"params": ..., "batch_stats": ...}`` numpy
    trees (convert with ``models.convert.state_dict_from_jax``)."""
    return load_npz(checkpoint_path(name))
