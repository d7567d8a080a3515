"""90th percentile of the window's MixingService.gains wall times, in ms."""

from portbench.core import readers


def read(run):
    return readers.percentile_ms(run, "latency_s", 90)
