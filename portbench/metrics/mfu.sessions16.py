"""Model FLOPs of the real chunks (every track's VGGish and post-processor,
from the family's counts) over window seconds x the dense TF32 peak, in %.
The frozen kernel table files the frontend's GEMM, FFT and conv1d kernels
under the trunk; this share reads no kernel time, only the window."""

from portbench.core import readers


def read(run):
    return readers.mfu(run)
