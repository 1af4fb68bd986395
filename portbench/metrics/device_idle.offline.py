"""Device idle share in the offline cells (see ``_device_idle``)."""

from portbench.metrics._device_idle import read_kind


def read(rec):
    return read_kind(rec, "serve", "saturated")
