"""Checkpoints: the npz reader and the flax -> torch name and layout map.

Copies of tpumix/models/convert.py:74-97 (``flax_scalar_to_torch``) and
:129-153 (``_unflatten`` / ``load_npz``); the port imports nothing of tpumix.

Layout maps: conv kernels flax ``[kh, kw, in, out]`` -> torch ``[out, in, kh,
kw]``; dense kernels ``[in, out]`` -> ``[out, in]``.  The head flatten order
coincides between NCHW and NHWC because the head conv has one output channel.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def flax_scalar_to_torch(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                         num_blocks: int = 5, num_heads: int = 4) -> Dict[str, np.ndarray]:
    """Flax scalar-model variables -> the reference's torch ``state_dict``
    naming (reference model_scalar_1s.py:211-232), as numpy arrays."""
    sd: Dict[str, np.ndarray] = {}
    for i in range(1, num_blocks + 1):
        blk = f"conv_b{i}"
        sd[f"{blk}.conv.weight"] = np.ascontiguousarray(
            _np(params[blk]["conv"]["kernel"]).transpose(3, 2, 0, 1)
        )
        sd[f"{blk}.conv.bias"] = _np(params[blk]["conv"]["bias"])
        sd[f"{blk}.batch_norm.weight"] = _np(params[blk]["bn"]["scale"])
        sd[f"{blk}.batch_norm.bias"] = _np(params[blk]["bn"]["bias"])
        sd[f"{blk}.batch_norm.running_mean"] = _np(batch_stats[blk]["bn"]["mean"])
        sd[f"{blk}.batch_norm.running_var"] = _np(batch_stats[blk]["bn"]["var"])
    for i in range(1, num_heads + 1):
        h = f"head{i}"
        sd[f"conv_head{i}.weight"] = np.ascontiguousarray(
            _np(params[h]["conv"]["kernel"]).transpose(3, 2, 0, 1)
        )
        sd[f"conv_head{i}.bias"] = _np(params[h]["conv"]["bias"])
        sd[f"fc_head{i}.weight"] = np.ascontiguousarray(_np(params[h]["fc"]["kernel"]).T)
        sd[f"fc_head{i}.bias"] = _np(params[h]["fc"]["bias"])
    return sd


# reference torch names -> the port module's names (which keep the flax
# module names: ``bn``, ``head{i}.conv``, ``head{i}.fc``)
_REFERENCE_TO_PORT = (
    (re.compile(r"^(conv_b\d+)\.batch_norm\."), r"\1.bn."),
    (re.compile(r"^conv_head(\d+)\."), r"head\1.conv."),
    (re.compile(r"^fc_head(\d+)\."), r"head\1.fc."),
)


def reference_to_port_names(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Rename a reference-layout state_dict to the port module's keys."""
    out = {}
    for key, val in sd.items():
        for pat, repl in _REFERENCE_TO_PORT:
            key = pat.sub(repl, key)
        out[key] = val
    return out


def state_dict_from_jax(variables: Mapping[str, Any], num_blocks: int = 5,
                        num_heads: int = 4) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` trees (numpy leaves) -> the
    ``state_dict`` of the port's scalar model (``load_state_dict`` strict)."""
    ref = flax_scalar_to_torch(variables["params"], variables["batch_stats"],
                               num_blocks, num_heads)
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in reference_to_port_names(ref).items()}
    for i in range(1, num_blocks + 1):
        sd[f"conv_b{i}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def load_npz(path: str) -> Dict[str, Any]:
    """Read an npz checkpoint -> ``{"params": ..., "batch_stats": ...}``."""
    with np.load(path) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    return {"params": tree.get("params", {}), "batch_stats": tree.get("batch_stats", {})}
