"""Configuration dataclasses (copy of tpumix/config.py:20-155, 222-234).

Kept as a copy, not an import: the port imports nothing of ``tpumix``.  The
one behavioural difference is :meth:`FrontendConfig.resolved_implementation`,
which takes the device the features will be computed on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_DIF_BLOCK = 128  # contiguous block size of the DIF split (n = 128*n1 + n2)


def dif_applicable(cfg: "FrontendConfig") -> bool:
    """The DIF factorization needs reshape-only framing (``n_fft % hop ==
    0``), 128-aligned blocks, an even block count (conjugate symmetry at
    N1/2) and center padding (tpumix/ops/stft_dif_pallas.py:66-77)."""
    n1v = cfg.n_fft // _DIF_BLOCK
    return (
        cfg.n_fft % cfg.hop_length == 0
        and cfg.hop_length % _DIF_BLOCK == 0
        and cfg.n_fft % _DIF_BLOCK == 0
        and n1v % 2 == 0
        and cfg.center
    )


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """STFT -> dB-magnitude feature frontend: ``torch.stft`` (periodic Hann,
    center, reflect, onesided) -> abs -> ``20*log10(max(|S|, amin))``."""

    n_fft: int = 2048
    hop_length: int = 1024
    sample_rate: int = 44100
    amin: float = 1e-5
    db_multiplier: float = 20.0
    center: bool = True
    pad_mode: str = "reflect"
    # "auto": the DIF factorized frontend where it applies (the hand-written
    #         kernel on cuda, its plain torch version on the CPU), else "fft"
    # "dif" : the DIF factorized frontend (tpumix_torch/ops/stft_dif.py)
    # "fft" : torch.stft
    implementation: str = "auto"

    def resolved_implementation(self, device=None) -> str:
        """Concrete implementation for features computed on ``device``.

        A config that the JAX package would send to its naive-basis or DIT
        Pallas kernels on a TPU (``n_fft % hop == 0`` but not DIF-applicable)
        has no Hopper kernel yet (ROADMAP.md kernels K3/K4) and raises on
        cuda rather than silently running another algorithm."""
        impl = self.implementation
        if impl not in ("auto", "dif", "fft"):
            raise NotImplementedError(
                f"frontend implementation {impl!r} is not ported; have 'auto', "
                "'dif', 'fft' (the naive-basis and DIT kernels are ROADMAP.md "
                "kernels K3/K4)"
            )
        if impl != "auto":
            return impl
        if dif_applicable(self):
            return "dif"
        on_cuda = device is not None and str(device).startswith("cuda")
        if on_cuda and self.n_fft % self.hop_length == 0:
            raise NotImplementedError(
                f"hop {self.hop_length} needs the naive-basis or DIT frontend "
                "kernel, which is not ported yet (ROADMAP.md kernels K3/K4); "
                "pass implementation='fft' to use torch.stft"
            )
        return "fft"

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        """Frame count for a signal of ``num_samples`` (center=True semantics:
        ``1 + num_samples // hop_length``, as torch.stft)."""
        if not self.center:
            return 1 + (num_samples - self.n_fft) // self.hop_length
        return 1 + num_samples // self.hop_length

    def chunk_samples(self, chunk_length_s: float) -> int:
        return int(round(chunk_length_s * self.sample_rate))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Gain-prediction model configuration; (chunk_length_s, hop_length) pin
    the frame budget each architecture's flattened head dim requires
    (scalar1s: 87 frames, 10290 = 490*21; scalar2s: 173 frames, 30807 =
    489*63)."""

    name: str = "scalar1s"
    chunk_length_s: float = 1.0
    hop_length: int = 512
    num_stems: int = 4
    dtype: str = "float32"
    compute_dtype: str = "float32"  # "bfloat16" runs the conv trunk in bf16
    # flax retained fraction 0.10 == torch BatchNorm2d(momentum=0.90)
    bn_momentum: float = 0.10
    use_dropout: bool = True
    # conv lowering: "auto" and "xla" = F.conv2d + BN + ReLU (cuDNN on the
    # card); "pallas" = the hand-written fused conv+BN+ReLU kernel
    # (tpumix_torch/ops/conv_block.py) for eligible blocks, as in JAX
    conv_impl: str = "auto"

    def frontend(self, base: Optional[FrontendConfig] = None) -> FrontendConfig:
        base = base or FrontendConfig()
        return dataclasses.replace(base, hop_length=self.hop_length)

    @property
    def num_frames(self) -> int:
        fe = self.frontend()
        return fe.num_frames(fe.chunk_samples(self.chunk_length_s))


def preset(name: str) -> ModelConfig:
    """Model presets with their pinned chunk/hop pairs."""
    presets = {
        "scalar1s": ModelConfig(name="scalar1s", chunk_length_s=1.0, hop_length=512),
        "scalar1sL": ModelConfig(name="scalar1sL", chunk_length_s=1.0, hop_length=512),
        "scalar2s": ModelConfig(name="scalar2s", chunk_length_s=2.0, hop_length=512),
        "scalar2sL": ModelConfig(name="scalar2sL", chunk_length_s=2.0, hop_length=512),
        "resnet18": ModelConfig(name="resnet18", chunk_length_s=5.0, hop_length=1024),
    }
    if name not in presets:
        raise ValueError(f"unknown model preset {name!r}; have {sorted(presets)}")
    return presets[name]


@dataclasses.dataclass(frozen=True)
class MixConfig:
    """Full-song mixing configuration (reference inference_utils.py:105-145
    ``mix_song_smooth``)."""

    chunk_length_s: float = 1.0
    savgol_polyorder: int = 2
    # Savitzky-Golay window = num_chunks // 4, forced odd; set to override
    savgol_window: Optional[int] = None
    # chunks per device call: one fixed-shape segment serves any song length
    max_chunks: int = 64
