"""Decode step's K/V cache reuse under a saturated queue (see
``_kv_reuse``)."""

from portbench.metrics._kv_reuse import read_mode


def read(rec):
    return read_mode(rec, "saturated")
