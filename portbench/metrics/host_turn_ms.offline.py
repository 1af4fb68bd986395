"""Engine host turn under a saturated queue (see ``_host_turn``)."""

from portbench.metrics._host_turn import read_mode


def read(rec):
    return read_mode(rec, "saturated")
