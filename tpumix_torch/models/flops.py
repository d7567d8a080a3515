"""Analytic FLOP accounting for the scalar gain models' conv trunk (a copy of
tpumix/models/flops.py: the port imports nothing of ``tpumix``).

The trunk's FLOPs divided by a measured time and the card's peak give its
rate and share of peak (``chip_smoke.py`` [study]).  Counting is
deliberately conservative — conv multiply-adds only (2 FLOPs per MAC), no
BN/ReLU/head/frontend work — so the rate is a floor.

Shape arithmetic mirrors the trunk exactly (tpumix_torch/models/scalar.py;
reference models/model_scalar_2s.py:68-89): five VALID ConvBlocks
(4->16 k3 s2 d in {1,2}, 16->32 k5, 32->48 k5, 48->64 k7, 64->128 k9, all
stride 1 after block 1) over a [F=1025, T=frames] spectrogram.  The derived
final spatial size is asserted against the reference's pinned flatten dims
(10290 = 490*21 at 87 frames dilation 1; 30807 = 489*63 at 173 frames
dilation 2, reference model_scalar_1s.py:220 / model_scalar_2s.py:77) so the
FLOP count cannot silently drift from the real architecture.
"""

from __future__ import annotations

from typing import List, Tuple

# (C_out, kernel, stride) per trunk block; C_in chains from the previous
# block (stems = 4 in).  Block 1's dilation is the 1s/2s model switch.
TRUNK_SPECS: Tuple[Tuple[int, int, int], ...] = (
    (16, 3, 2),
    (32, 5, 1),
    (48, 5, 1),
    (64, 7, 1),
    (128, 9, 1),
)

# reference-pinned head flatten dims (H5 * W5 of the conv5 output)
_PINNED_FLATTEN = {(1, 87): 10290, (2, 173): 30807}


def _valid_out(size: int, k: int, stride: int, dilation: int) -> int:
    eff = dilation * (k - 1) + 1
    return (size - eff) // stride + 1


def trunk_layer_flops(
    block1_dilation: int, frames: int, freq_bins: int = 1025
) -> List[Tuple[str, int]]:
    """Per-conv-layer FLOPs (2 * MACs) for ONE item ``[4, freq_bins, frames]``."""
    h, w, c_in = freq_bins, frames, 4
    out = []
    for i, (c_out, k, s) in enumerate(TRUNK_SPECS):
        d = block1_dilation if i == 0 else 1
        h, w = _valid_out(h, k, s, d), _valid_out(w, k, s, d)
        out.append((f"conv{i + 1}", 2 * h * w * c_out * k * k * c_in))
        c_in = c_out
    key = (block1_dilation, frames)
    if key in _PINNED_FLATTEN and h * w != _PINNED_FLATTEN[key]:
        raise AssertionError(
            f"trunk shape arithmetic drifted: conv5 {h}x{w} != pinned flatten "
            f"{_PINNED_FLATTEN[key]} for dilation={block1_dilation}, frames={frames}"
        )
    return out


def trunk_flops_per_item(block1_dilation: int, frames: int) -> int:
    """Total conv-trunk FLOPs for one ``[4, 1025, frames]`` input item."""
    return sum(f for _, f in trunk_layer_flops(block1_dilation, frames))
