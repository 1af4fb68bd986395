"""Expert layer: the share of the window's busy device time launched
inside the ``moe.*`` spans, forward and backward (see ``_moe``)."""

from portbench.metrics._moe import moe_share


def read(rec):
    return moe_share(rec)
