"""Configuration dataclasses (copy of tpumix/config.py).

Kept as a copy, not an import: the port imports nothing of ``tpumix``.  The
one behavioural difference is :meth:`FrontendConfig.resolved_implementation`:
``"auto"`` picks the best applicable fused frontend on every device (the
hand-written kernel on cuda, its plain torch version on the CPU), where the
JAX package does so on TPU backends only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

_DIF_BLOCK = 128  # contiguous block size of the DIF split (n = 128*n1 + n2)
_CT_N1 = 16  # phase count of the DIT split (n = 16*n2 + p)

# concrete implementations, under the JAX package's names
_IMPLEMENTATIONS = ("dif_pallas", "ct_pallas", "pallas", "fft", "matmul", "ct")


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


def ct_applicable(cfg: "FrontendConfig") -> bool:
    """The DIT factorization needs reshape-only framing (``n_fft % hop ==
    0``) and phase decimation that lands on whole rows (``hop % 16 == 0``)
    (tpumix/ops/stft.py:126-134)."""
    return (
        cfg.n_fft % cfg.hop_length == 0
        and cfg.hop_length % _CT_N1 == 0
        and cfg.n_fft % _CT_N1 == 0
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
    # "auto"      : the best applicable fused frontend, in the JAX package's
    #               TPU order: dif_pallas -> ct_pallas -> pallas, else "fft"
    # "dif_pallas": decimation-in-frequency factorized frontend
    #               (tpumix_torch/ops/stft_dif.py; "dif" is an alias)
    # "ct_pallas" : decimation-in-time factorized frontend
    #               (tpumix_torch/ops/stft_ct.py)
    # "pallas"    : naive windowed-basis frontend, any n_fft % hop == 0
    #               (tpumix_torch/ops/stft_basis.py)
    # "fft"       : torch.stft
    # "matmul"    : one float32 product with a windowed [n_fft, 2*bins] DFT basis
    # "ct"        : the float32 Cooley-Tukey factorized DFT (16 phases), or
    #               "matmul" where ct_applicable fails
    # The names are the JAX package's, so one config selects the same
    # algorithm in both.  Each fused frontend is a hand-written kernel on
    # cuda and its plain torch version on the CPU; "matmul" and "ct" are
    # XLA-level formulations in the JAX package and plain torch here.
    implementation: str = "auto"

    def resolved_implementation(self) -> str:
        """Concrete implementation, one of ``"dif_pallas"``, ``"ct_pallas"``,
        ``"pallas"``, ``"fft"``, ``"matmul"``, ``"ct"``; the same on every
        device.  ``"auto"`` never picks ``"matmul"`` or ``"ct"``, as in the
        JAX package."""
        impl = "dif_pallas" if self.implementation == "dif" else self.implementation
        if impl in _IMPLEMENTATIONS:
            return impl
        if impl != "auto":
            raise ValueError(
                f"unknown frontend implementation {impl!r}; have 'auto', 'dif', "
                f"{_IMPLEMENTATIONS}"
            )
        if dif_applicable(self):
            return "dif_pallas"
        if ct_applicable(self):
            return "ct_pallas"
        if self.n_fft % self.hop_length == 0:
            return "pallas"
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
    # conv lowering: "xla" = F.conv2d + BN + ReLU (cuDNN on the card);
    # "pallas" = the hand-written fused conv+BN+ReLU kernel
    # (tpumix_torch/ops/conv_block.py) for eligible blocks, as in JAX;
    # "auto" = that kernel for eval-mode blocks on the card, else "xla"
    # (tpumix_torch/models/blocks.py::takes_fused_kernel);
    # "khgemm" / "khgemm_hybrid" / "khgemm_int8" = the kh-unrolled GEMM
    # lowerings (tpumix_torch/ops/conv_khgemm.py; int8 is inference only)
    conv_impl: str = "auto"
    # the model's input: "db_stft" = each stem's dB STFT per chunk (the
    # frontend above); "vggish" = each track's 16 kHz log-mel example per
    # 0.96 s chunk, framed across chunk edges (tpumix_torch/ops/vggish.py),
    # for a model of any number of tracks and a stereo mix
    features: str = "db_stft"

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
        # 0.96 s = 42336 samples: one VGGish example a chunk; the track count
        # is the song's (num_stems is not read)
        "dmc_vggish": ModelConfig(name="dmc_vggish", chunk_length_s=0.96, hop_length=160,
                                  features="vggish"),
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration (parity targets: reference model_trainer.py
    and training_ignite.ipynb cells 12-15)."""

    batch_size: int = 48
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5  # Adam L2 (torch-style coupled), training.ipynb cell 11
    num_epochs: int = 20
    # early-stopping patience; None resolves per-loss in the trainer
    # (train.trainer.resolve_patience): 30 for the lstsq family, else 10
    early_stopping_patience: Optional[int] = None
    checkpoint_dir: str = "./checkpoints"
    keep_checkpoints: Optional[int] = None  # None = keep all (ignite n_saved=None)
    # keep-best-k scoring: "train" = ignite parity (-train_mse); "val" keeps
    # the best validation epochs
    checkpoint_score: str = "train"
    # "constant" = reference parity; "cosine" decays learning_rate -> 0.01x
    # over lr_total_steps (required for cosine)
    lr_schedule: str = "constant"
    lr_total_steps: Optional[int] = None
    seed: int = 0
    log_every_steps: int = 30  # ignite iteration logging cadence (cell 14)
    augment: bool = False
    # reference parity: augmentation re-gains ALL FIVE tracks, the mix
    # included (reference data/dataset.py:185-199).  False keeps the
    # supervision mix clean — required for the lstsq-family objectives under
    # augmentation (an independent mix gain is unobservable from the stems)
    augment_mix: bool = True
    # "reference", "roundtrip", "coherent", "lstsq", "lstsq_tail",
    # "lstsq_tail_cm" (tpumix_torch.train.state.SELF_SUPERVISED_LOSSES), or
    # "gain": direct MSE on generator gain labels (make_gain_train_step)
    loss: str = "reference"
    # "int16": ship waveform batches as 16-bit PCM with on-device
    # dequantisation; "mulaw8": int8 mu-law
    transfer_dtype: str = "float32"
    mesh_shape: Tuple[int, ...] = (1,)  # data-parallel axis sizes (ROADMAP.md item 15)
    mesh_axis_names: Tuple[str, ...] = ("dp",)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    base_path: str = ""
    layout: str = "medleydb"  # or "musdb18"
    chunk_length_s: float = 1.0
    sample_rate: int = 44100
    normalize: bool = False
    augment: bool = False
    seed: Optional[int] = None
