"""Model FLOPs of the real chunks over window seconds x the dense TF32 peak, in %."""

from portbench.core import readers


def read(run):
    return readers.mfu(run)
