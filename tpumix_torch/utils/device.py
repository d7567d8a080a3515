"""Device selection: the port runs on the card unless asked otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; there is no silent fall-back to the CPU.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and none is present.  Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU.  ``cuda`` without an index
    resolves to the current card (``cuda:0``), the device its tensors report,
    so a tensor's device compares equal to the resolved one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def disable_tf32() -> None:
    """Full-f32 conformance: cuDNN convolutions default to TF32 (about three
    decimal digits), which over +/-100 dB features would use up the 1e-3
    gain budget; the JAX reference runs its DFT dots at Precision.HIGHEST for
    the same reason (tpumix/ops/stft_pallas.py:84-86)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
