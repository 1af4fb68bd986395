"""Decode step under a saturated queue (see ``_decode_mfu``)."""

from portbench.metrics._decode_mfu import read_mode


def read(rec):
    return read_mode(rec, "saturated")
