"""K2 and K3, the flash-attention backward, in training (see
``_attn_roofline``)."""

from portbench.metrics._attn_roofline import read_group


def read(rec):
    return read_group(rec, "attn_bwd")
