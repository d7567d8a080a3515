"""K1's byte bound over the real chunks, over its summed kernel time, in %."""

from portbench.core import readers


def read(run):
    return readers.k1_roofline(run)
