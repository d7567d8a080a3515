"""Audio seconds of every song mixed and home in the window, over its seconds."""

from portbench.core import readers


def read(run):
    return readers.rate(run, "audio_s")
