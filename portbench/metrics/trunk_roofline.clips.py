"""The trunk's and heads' FLOP bound over the real chunks, over their kernels' time, in %."""

from portbench.core import readers


def read(run):
    return readers.trunk_roofline(run)
