"""Checkpoints: the npz reader and writer and the flax <-> torch name and
layout maps.

Copies of tpumix/models/convert.py:36-97 (``torch_scalar_to_flax``,
``flax_scalar_to_torch``) and :120-153 (``_flatten`` / ``_unflatten`` /
``save_npz`` / ``load_npz``); the port imports nothing of tpumix.  An ``.npz``
written here from a port-trained model is the tree tpumix's ``load_npz``
reads.

Layout maps: conv kernels flax ``[kh, kw, in, out]`` -> torch ``[out, in, kh,
kw]``; dense kernels ``[in, out]`` -> ``[out, in]``.  The head flatten order
coincides between NCHW and NHWC because the head conv has one output channel.

The scalar models go through the reference's torch names; ``GainResNet``
keeps the flax module names (``stem_conv``, ``stem_bn``,
``layer{s}_block{b}.{conv1,bn1,conv2,bn2,shortcut_conv,shortcut_bn}``,
``head{i}.{conv,fc}``), so its map is name for name (``_named_from_jax``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def torch_scalar_to_flax(state_dict: Mapping[str, Any], num_blocks: int = 5,
                         num_heads: int = 4) -> Tuple[Dict, Dict]:
    """Reference-named scalar-model ``state_dict`` -> flax ``(params,
    batch_stats)`` trees of numpy arrays (the inverse of
    :func:`flax_scalar_to_torch`)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(1, num_blocks + 1):
        blk = f"conv_b{i}"
        params[blk] = {
            "conv": {
                "kernel": _np(state_dict[f"{blk}.conv.weight"]).transpose(2, 3, 1, 0),
                "bias": _np(state_dict[f"{blk}.conv.bias"]),
            },
            "bn": {
                "scale": _np(state_dict[f"{blk}.batch_norm.weight"]),
                "bias": _np(state_dict[f"{blk}.batch_norm.bias"]),
            },
        }
        stats[blk] = {
            "bn": {
                "mean": _np(state_dict[f"{blk}.batch_norm.running_mean"]),
                "var": _np(state_dict[f"{blk}.batch_norm.running_var"]),
            }
        }
    for i in range(1, num_heads + 1):
        params[f"head{i}"] = {
            "conv": {
                "kernel": _np(state_dict[f"conv_head{i}.weight"]).transpose(2, 3, 1, 0),
                "bias": _np(state_dict[f"conv_head{i}.bias"]),
            },
            "fc": {
                "kernel": _np(state_dict[f"fc_head{i}.weight"]).T,
                "bias": _np(state_dict[f"fc_head{i}.bias"]),
            },
        }
    return params, stats


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


# the port module's names -> reference torch names (inverse of the above)
_PORT_TO_REFERENCE = (
    (re.compile(r"^(conv_b\d+)\.bn\."), r"\1.batch_norm."),
    (re.compile(r"^head(\d+)\.conv\."), r"conv_head\1."),
    (re.compile(r"^head(\d+)\.fc\."), r"fc_head\1."),
)


def _named_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables -> the ``state_dict`` of a port module whose names are
    the flax ones: ``kernel`` -> ``weight`` (conv and dense layouts), BN
    ``scale`` / ``bias`` / ``mean`` / ``var`` -> ``weight`` / ``bias`` /
    ``running_mean`` / ``running_var``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix, leaf_names):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.", leaf_names)
                continue
            arr = np.array(_np(val), dtype=np.float32)
            if key == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            sd[prefix + leaf_names[key]] = torch.from_numpy(np.ascontiguousarray(arr))
            if key == "mean":
                sd[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    walk(variables["params"], "", {"kernel": "weight", "scale": "weight", "bias": "bias"})
    walk(variables["batch_stats"], "", {"mean": "running_mean", "var": "running_var"})
    return sd


def _named_to_jax(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`_named_from_jax`."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, val in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        arr = _np(val)
        is_bn = f"{module}.running_mean" in state_dict
        if leaf in ("running_mean", "running_var"):
            tree, name = stats, {"running_mean": "mean", "running_var": "var"}[leaf]
        elif leaf == "weight" and is_bn:
            tree, name = params, "scale"
        elif leaf == "weight":
            tree, name = params, "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        else:
            tree, name = params, leaf
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return {"params": params, "batch_stats": stats}


def state_dict_to_jax(state_dict: Mapping[str, Any], num_blocks: int = 5,
                      num_heads: int = 4) -> Dict[str, Any]:
    """The ``state_dict`` of the port's model -> JAX ``{"params",
    "batch_stats"}`` trees (numpy leaves); the inverse of
    :func:`state_dict_from_jax`."""
    if "stem_conv.weight" in state_dict:  # GainResNet
        return _named_to_jax(state_dict)
    ref = {}
    for key, val in state_dict.items():
        for pat, repl in _PORT_TO_REFERENCE:
            key = pat.sub(repl, key)
        ref[key] = val
    params, stats = torch_scalar_to_flax(ref, num_blocks, num_heads)
    return {"params": params, "batch_stats": stats}


def state_dict_from_jax(variables: Mapping[str, Any], num_blocks: int = 5,
                        num_heads: int = 4) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` trees (numpy leaves) -> the
    ``state_dict`` of the port's model (``load_state_dict`` strict)."""
    if "stem_conv" in variables["params"]:  # GainResNet
        return _named_from_jax(variables)
    ref = flax_scalar_to_torch(variables["params"], variables["batch_stats"],
                               num_blocks, num_heads)
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in reference_to_port_names(ref).items()}
    for i in range(1, num_blocks + 1):
        sd[f"conv_b{i}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, val in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(val, Mapping):
            _flatten(val, path, out)
        else:
            out[path] = _np(val)


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_npz(path: str, params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> None:
    """Write inference variables as a single compressed ``.npz`` of flat
    ``params/<path>`` and ``batch_stats/<path>`` arrays."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "params", flat)
    _flatten(batch_stats or {}, "batch_stats", flat)
    np.savez_compressed(path, **flat)


def load_npz(path: str) -> Dict[str, Any]:
    """Read an npz checkpoint -> ``{"params": ..., "batch_stats": ...}``."""
    with np.load(path) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    return {"params": tree.get("params", {}), "batch_stats": tree.get("batch_stats", {})}
