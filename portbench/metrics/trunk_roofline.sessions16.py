"""The model's FLOP bound over the real chunks (every track's VGGish and
post-processor, from the family's counts) at the dense TF32 peak, over the
summed time of the kernels the frozen table files under the trunk, in %.
That table also files the frontend's resampling GEMM, its FFT and the
epilogue's conv1d under the trunk, so the share is a floor."""

from portbench.core import readers


def read(run):
    return readers.trunk_roofline(run)
