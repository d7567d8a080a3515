"""The Differentiable Mixing Console (Steinmetz, Pons, Pascual and Serra,
"Automatic multitrack mixing with a differentiable mixing console of neural
audio effects", ICASSP 2021, arXiv:2010.10291; csteinmetz1/automix-toolkit
``automix/models/dmc.py``) with the VGGish encoder (Hershey et al., ICASSP
2017; tensorflow/models research/audioset/vggish ``vggish_slim.py``).

Per chunk of a song with any number N of tracks:

* **encoder**, weights shared by the tracks (tracks are batch rows): each
  track's ``[96, 64]`` log-mel example (``ops/vggish.py``) through VGGish:
  3x3 SAME conv + bias + ReLU blocks 64 | 128 | 256, 256 | 512, 512, a 2x2
  max-pool after each group, the ``[6, 4, 512]`` map flattened in NHWC
  order, fc 4096 + ReLU, fc 4096 + ReLU, fc 128: an embedding ``e_t``;
* **context** ``c``: the mean of the chunk's N embeddings;
* **post-processor**, per track: ``[e_t ; c]`` (256) -> dense 256, PReLU,
  dense 256, PReLU, dense 2, sigmoid: ``(p0, p1)`` (dropout 0.2 after each
  hidden dense acts in training only);
* **console**: ``gain_dB = -48 + 72 p0``, ``theta = p1 pi / 2``, and the
  constant-power amplitudes ``a_L = 10^(gain_dB / 20) cos(theta)``,
  ``a_R = 10^(gain_dB / 20) sin(theta)``.

:meth:`DifferentiableMixingConsole.gains` maps ``[chunks, N, 96, 64]``
examples to ``[chunks, N, 2]`` amplitudes ``(a_L, a_R)``; ``SongMixer``
smooths them and mixes the tracks to stereo.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpumix_torch.models.blocks import ConvReLU2d

EMBEDDING = 128
HIDDEN = 256  # the post-processor's width (an assumed size: the paper gives none)
GAIN_DB_RANGE = (-48.0, 24.0)
# VGGish's conv blocks: (name, output channels, max-pool after it)
VGGISH_CONVS = (("conv1", 64, True), ("conv2", 128, True), ("conv3_1", 256, False),
                ("conv3_2", 256, True), ("conv4_1", 512, False), ("conv4_2", 512, True))
VGGISH_FLAT = 6 * 4 * 512  # the [96, 64] example after four 2x2 pools, NHWC


class VGGish(nn.Module):
    """``[B, 96, 64]`` log-mel examples -> ``[B, 128]`` embeddings."""

    def __init__(self, conv_impl: str = "auto"):
        super().__init__()
        cin = 1
        for name, cout, _ in VGGISH_CONVS:
            setattr(self, name, ConvReLU2d(cin, cout, conv_impl))
            cin = cout
        self.fc1_1 = nn.Linear(VGGISH_FLAT, 4096)
        self.fc1_2 = nn.Linear(4096, 4096)
        self.fc2 = nn.Linear(4096, EMBEDDING)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]
        for name, _, pool in VGGISH_CONVS:
            h = getattr(self, name)(h)
            if pool:
                h = F.max_pool2d(h, 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # NHWC order, as vggish_slim
        h = torch.relu(self.fc1_1(h))
        h = torch.relu(self.fc1_2(h))
        return self.fc2(h)


class PostProcessor(nn.Module):
    """``[..., 2 * EMBEDDING]`` -> ``[..., 2]`` parameters in (0, 1)."""

    def __init__(self, dropout_p: float = 0.2):
        super().__init__()
        self.dense1 = nn.Linear(2 * EMBEDDING, HIDDEN)
        self.act1 = nn.PReLU()
        self.dense2 = nn.Linear(HIDDEN, HIDDEN)
        self.act2 = nn.PReLU()
        self.dense3 = nn.Linear(HIDDEN, 2)
        self.dropout = nn.Dropout(dropout_p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act1(self.dropout(self.dense1(x)))
        h = self.act2(self.dropout(self.dense2(h)))
        return torch.sigmoid(self.dense3(h))


def console(p: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` parameters ``(p0, p1)`` -> ``[..., 2]`` amplitudes
    ``(a_L, a_R)``: gain over ``GAIN_DB_RANGE``, constant-power pan."""
    lo, hi = GAIN_DB_RANGE
    gain = torch.pow(10.0, (lo + (hi - lo) * p[..., 0]) / 20.0)
    theta = p[..., 1] * (math.pi / 2)
    return torch.stack([gain * torch.cos(theta), gain * torch.sin(theta)], dim=-1)


class DifferentiableMixingConsole(nn.Module):
    """The encoder, the cross-track context, the post-processor and the
    console; any number of tracks, one parameter set per chunk."""

    def __init__(self, conv_impl: str = "auto"):
        super().__init__()
        self.encoder = VGGish(conv_impl)
        self.post = PostProcessor()

    def gains(self, x: torch.Tensor) -> torch.Tensor:
        """``x [chunks, N, 96, 64]`` -> ``[chunks, N, 2]`` amplitudes
        ``(a_L, a_R)`` float32."""
        n, tracks = x.shape[:2]
        e = self.encoder(x.to(torch.float32).reshape(n * tracks, *x.shape[2:]))
        e = e.reshape(n, tracks, EMBEDDING)
        c = e.mean(dim=1, keepdim=True).expand(n, tracks, EMBEDDING)
        return console(self.post(torch.cat([e, c], dim=-1)))

    forward = gains


def init_dmc_weights(model: DifferentiableMixingConsole,
                     generator: torch.Generator) -> DifferentiableMixingConsole:
    """The console's init from an explicit generator: He-normal (std
    ``sqrt(2 / fan_in)``) for the layers a ReLU follows (VGGish's
    convolutions and its first two dense layers), lecun-normal for the
    others, zero biases; the PReLU slopes keep torch's 0.25."""
    relu = {name for name, _, _ in VGGISH_CONVS} | {"fc1_1", "fc1_2"}
    with torch.no_grad():
        for name, m in model.encoder.named_children():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _normal(m, 2.0 if name in relu else 1.0, generator)
        for m in (model.post.dense1, model.post.dense2, model.post.dense3):
            _normal(m, 1.0, generator)
    return model


def _normal(m: nn.Module, gain: float, generator: torch.Generator) -> None:
    m.weight.normal_(0.0, (gain / m.weight[0].numel()) ** 0.5, generator=generator)
    nn.init.zeros_(m.bias)
