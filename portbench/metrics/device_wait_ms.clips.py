"""Mean host time a request waits for its segment's gains from the card (mixer.collect), in ms."""

from portbench.core import program_spans


def read(run):
    return program_spans.per_request_ms(run, ["mixer.collect"])
