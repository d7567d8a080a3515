"""Frame-axis ("sequence") sharding of the scalar trunk over an ``sp`` mesh
axis (the ``sp_axis`` of tpumix/train/state.py:429-489).

The JAX step annotates the features ``P(dp, None, None, sp)`` and GSPMD
inserts the convolutions' halo exchanges.  Here the work is split by the
trunk's last layer instead: each ``sp`` rank owns a contiguous range of
conv5 output frames and computes, from its own copy of the waveforms (every
rank of a ``dp`` group holds the same rows), the features and every trunk
layer over the frames that range needs.  Neighbouring ranks recompute the
overlap; no halo is sent (gloo cannot send CUDA tensors point to point).

The step stays the one-process step on the global batch:

* at every layer the ranks' *owned* frames partition the layer's frames:
  rank r owns ``[start_r, start_{r+1})``, the last rank up to the end.
  BatchNorm takes its statistics over the owned frames only, summed over the
  whole ``dp x sp`` group, never over recomputed overlap;
* each head's dense layer takes this rank's conv5 columns of the NCHW
  ``[H*W]`` flatten, and the partial dots are summed over ``sp`` with an
  identity backward (:meth:`MeshAxis.sum_identity_grad`);
* losses that sum over feature frames sum over the owned feature frames,
  then over ``sp``; the gradients are summed over ``sp`` and averaged over
  ``dp``.

Its cost is the recompute: one conv5 frame needs 49 feature frames in
``scalar2s`` and 47 in ``scalar1s``, so at ``sp = 2`` on 173 frames each
rank computes about 64% of the features and of the trunk.  The axis is here
for fidelity to the JAX step, not for speed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch

from tpumix_torch.config import FrontendConfig
from tpumix_torch.parallel.distributed import shard_range


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """This ``sp`` rank's part of the frame axis of a trunk.

    ``ranges[0]`` is the features', ``ranges[i]`` layer i's output, each
    ``(lo, hi, own_hi, width)`` in that layer's global frame indices: the
    rank computes ``[lo, hi)`` and owns ``[lo, own_hi)`` of ``width``.
    ``rows`` is the number of ``dp`` ranks (BatchNorm's global count)."""

    axis: object  # MeshAxis of the sp ranks
    rows: int
    ranges: Tuple[Tuple[int, int, int, int], ...]

    @classmethod
    def build(cls, frames: int, layers: Sequence[Tuple[int, int, int]], axis, rows: int = 1
              ) -> "FrameShard":
        """``layers``: ``(kernel, stride, dilation)`` of the trunk's VALID
        convolutions along the frame axis, first to last."""
        widths = [frames]
        for k, s, d in layers:
            widths.append((widths[-1] - d * (k - 1) - 1) // s + 1)
        if widths[-1] < axis.size:
            raise ValueError(f"{frames} frames leave {widths[-1]} output frames, fewer than the "
                             f"{axis.size} ranks of axis {axis.name!r}")
        last = axis.index == axis.size - 1
        lo, hi = shard_range(widths[-1], axis.index, axis.size)
        own = widths[-1] if last else hi
        ranges = [(lo, hi, own, widths[-1])]
        for (k, s, d), width in zip(reversed(layers), reversed(widths[:-1])):
            lo, hi = s * lo, s * (hi - 1) + d * (k - 1) + 1
            own = width if last else s * own
            if last:
                hi = width  # the tail frames no output reads are still owned
            ranges.insert(0, (lo, hi, own, width))
        return cls(axis, rows, tuple(ranges))

    @property
    def features(self) -> Tuple[int, int]:
        """The feature frames ``[lo, hi)`` this rank computes."""
        return self.ranges[0][:2]

    @property
    def owned_features(self) -> Tuple[int, int]:
        """The feature frames ``[lo, own_hi)`` this rank owns."""
        return self.ranges[0][0], self.ranges[0][2]

    def owned(self, layer: int) -> Tuple[int, int]:
        """``(frames owned from the start of the local tensor, global width)``
        of layer ``layer`` (0: the features)."""
        lo, _, own, width = self.ranges[layer]
        return own - lo, width


def frame_features(features: Callable, x: torch.Tensor, cfg: FrontendConfig, lo: int,
                   hi: int) -> torch.Tensor:
    """``features(x)[..., lo:hi]`` (``features``: ``[..., S] -> [..., F, T]``
    with ``cfg``'s centre framing) computed from the samples those frames
    read and a margin: a frame whose window lies inside the slice, or
    reaches past it only where the slice ends with the signal, is the same
    frame of the whole signal."""
    hop, S = cfg.hop_length, x.shape[-1]
    margin = -(-(cfg.n_fft // 2) // hop)
    s0 = max(0, (lo - margin) * hop)
    s1 = min(S, (hi + margin) * hop)
    j0 = lo - s0 // hop
    return features(x[..., s0:s1])[..., j0: j0 + hi - lo]
