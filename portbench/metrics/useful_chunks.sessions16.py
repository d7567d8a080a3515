"""Real chunks over the chunks the dispatched segments ran (the mixer's counters), in %."""

from portbench.core import program_spans


def read(run):
    return program_spans.counter_share(run, "mixer.chunks_real", "mixer.chunks_run")
