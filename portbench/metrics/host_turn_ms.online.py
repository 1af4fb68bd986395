"""Engine host turn under open-loop traffic (see ``_host_turn``)."""

from portbench.metrics._host_turn import read_mode


def read(rec):
    return read_mode(rec, "open")
