"""Mean host time packing a request's segment into the pinned buffer (mixer.pack), in ms."""

from portbench.core import program_spans


def read(run):
    return program_spans.per_request_ms(run, ["mixer.pack"])
