"""The model families of the reference, one module each, found by the
configuration's ``family`` name as drivers and metrics are found by theirs.

A family module ``<family>.py`` holds everything of the yardstick that
depends on the model, and provides:

* ``param_shapes(cfg)``: ``name -> (shape, kind)`` of every parameter and
  buffer, in the order in which the seeded weights are drawn;
* ``features(stems, first, count, cfg)``: the model's input for chunks
  ``[first, first + count)`` of ``stems [stems, S]`` (a tensor on the device);
* ``forward(w, x, cfg, calibrate)``: the plain float32 forward pass from a
  weight dict; with ``calibrate`` every BatchNorm sets its running
  statistics from the batch;
* ``song(weights, stems, cfg, device)`` -> ``(curves, mix)`` and
  ``clip(weights, stems, cfg, device)`` -> ``(raw, smoothed)``: what the
  mixer and the service produce from one song's stems;
* ``trunk_layers(cfg)`` -> ``([(layer, FLOPs)], (C, H, W))``,
  ``model_flops_per_chunk(cfg)`` and ``frontend_bytes_per_chunk(cfg)``;
* optionally ``KINDS``: ``kind -> init(x, shape, wcfg)`` for the weight
  kinds that ``core/weights.py`` does not know.

The shared parts are libraries the families import: ``frontend.py`` (the
dB STFT), ``epilogue.py`` (Savitzky-Golay, mono mixdown), ``models.py``
(BatchNorm and the scalar heads), ``counts.py`` (peaks and count
arithmetic), ``pipeline.py`` (a song's outputs in blocks of chunks).
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def available() -> List[str]:
    """The families that have a module here."""
    return sorted(f[:-3] for f in os.listdir(HERE)
                  if f.endswith(".py") and not f.startswith("_"))


def find(cfg: Dict) -> str:
    """The module name of the family that ``cfg["family"]`` names; a
    ``RunError`` (exit 1) where it has no module here."""
    name = cfg.get("family")
    if not (isinstance(name, str) and name.isidentifier() and not name.startswith("_")
            and os.path.exists(os.path.join(HERE, f"{name}.py"))):
        from portbench.core.harness import RunError

        raise RunError(1, f"configuration {cfg.get('name')!r} names the model family "
                          f"{name!r}, which has no module in reference/families; "
                          f"found {available()}")
    return f"{__name__}.{name}"


def of(cfg: Dict):
    """The family module that ``cfg["family"]`` names."""
    return importlib.import_module(find(cfg))
