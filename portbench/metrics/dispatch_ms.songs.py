"""Mean host time of one mix_song_smooth_device call (enqueue and the pageable H2D), in ms."""

from portbench.core import readers


def read(run):
    return readers.mean_ms(run, "dispatch_s")
