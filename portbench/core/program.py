"""The benchmark's calls into the program (``tpumix_torch``): the model
built from its preset and given the benchmark's weights, the mixer and the
service as the CLI builds them.  Nothing else of the harness imports the
program."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from portbench.core import weights as seeded


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    """Start the peak from here: the program's set-up and window, not the
    benchmark's own generation of inputs and weights."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def weights(cfg: Dict, seed: int, first_item: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """Seeded weights on ``device``, BN statistics from ``first_item``."""
    w = seeded.make(cfg, seed, device)
    seeded.calibrate(w, torch.as_tensor(first_item, device=device), cfg)
    return w


def model_config(cfg: Dict, overrides: Dict):
    from tpumix_torch.config import preset

    mc = preset(cfg["preset"])
    return dataclasses.replace(mc, conv_impl=cfg["conv_impl"])


def model(cfg: Dict, w: Dict[str, torch.Tensor], device, overrides: Dict):
    from tpumix_torch.models.registry import build_model

    mc = model_config(cfg, overrides)
    m = build_model(mc).to(device)
    seeded.load_into(m, w)
    return m, mc


def mixer(cfg: Dict, w: Dict[str, torch.Tensor], device, overrides: Dict):
    """``SongMixer`` as ``mix`` builds it (default segment and wire);
    ``overrides["max_chunks"]`` (tests only) shortens the segment."""
    from tpumix_torch.config import MixConfig
    from tpumix_torch.infer.mixer import SongMixer

    m, mc = model(cfg, w, device, overrides)
    mix_cfg = None
    if "max_chunks" in overrides:
        mix_cfg = MixConfig(chunk_length_s=mc.chunk_length_s, max_chunks=overrides["max_chunks"])
    return SongMixer(m, mc, mix_cfg=mix_cfg, device=device)


def service(cfg: Dict, w: Dict[str, torch.Tensor], device, overrides: Dict):
    """``MixingService`` as ``serve`` builds it, warmed on the paths this
    traffic takes (``/gains``; not ``/stream``), without the socket."""
    from tpumix_torch.serve import MixingService

    svc = MixingService(mixer(cfg, w, device, overrides))
    svc.warm(stream=False)
    return svc


def free(obj, device) -> None:
    """Drop the program's objects and return their device memory."""
    del obj
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
