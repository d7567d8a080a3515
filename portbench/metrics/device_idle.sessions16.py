"""Share of the traced window with no device operation, in %."""

from portbench.core import readers


def read(run):
    return readers.device_idle(run)
