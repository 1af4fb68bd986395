"""K1, the flash-attention forward, in training (see ``_attn_roofline``)."""

from portbench.metrics._attn_roofline import read_group


def read(rec):
    return read_group(rec, "attn_fwd")
