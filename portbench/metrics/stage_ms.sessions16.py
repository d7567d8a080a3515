"""Mean host time a song spends staging its tracks on the card (the
pageable host-to-card copy, the program's ``mixer.stage`` span), per
``mixer.song`` span in the window, in ms.  None where the program has no
such span."""

from portbench.core import program_spans

SONG, STAGE = "mixer.song", "mixer.stage"


def read(run):
    got = program_spans.records(run)
    if got is None:
        return None
    spans = got[0]
    songs = sum(1 for s in spans if s.name == SONG)
    staged = [s.end_ns - s.start_ns for s in spans if s.name == STAGE]
    if songs == 0 or not staged:
        return None
    return sum(staged) * 1e-6 / songs
