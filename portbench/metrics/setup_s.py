"""Process start to the window's start, in seconds."""

from portbench.core import readers


def read(run):
    return readers.setup_s(run)
