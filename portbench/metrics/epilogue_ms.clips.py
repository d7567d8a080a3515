"""Mean host time of a request's channel mean and numpy epilogue (mixer.downmix, mixer.epilogue), in ms."""

from portbench.core import program_spans


def read(run):
    return program_spans.per_request_ms(run, ["mixer.downmix", "mixer.epilogue"])
