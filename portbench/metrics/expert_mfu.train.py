"""Expert layer: the expert products' model work over the device time
inside the ``moe.experts`` spans, at the bf16 peak (see ``_moe``)."""

from portbench.metrics._moe import expert_mfu


def read(rec):
    return expert_mfu(rec)
