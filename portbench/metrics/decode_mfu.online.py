"""Decode step under open-loop traffic (see ``_decode_mfu``)."""

from portbench.metrics._decode_mfu import read_mode


def read(rec):
    return read_mode(rec, "open")
