"""K1, the flash-attention forward, over windowed and full layers (see
``_attn_window``)."""

from portbench.metrics._attn_window import read_group


def read(rec):
    return read_group(rec, "attn_fwd")
