"""tpumix_torch — the PyTorch / CUDA port of tpumix for NVIDIA Hopper.

The JAX package ``tpumix`` is the reference; this package imports nothing of
it.  Plain tensor code is PyTorch; every Pallas kernel on the ported path is a
hand-written CUDA kernel for ``sm_90a`` (``tpumix_torch/csrc``), built with
nvcc at first use and bound with ctypes.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from tpumix_torch.config import (  # noqa: F401
    FrontendConfig,
    MixConfig,
    ModelConfig,
    preset,
)
