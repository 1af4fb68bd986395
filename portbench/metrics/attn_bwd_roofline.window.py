"""K2 and K3, the flash-attention backward, over windowed and full
layers (see ``_attn_window``)."""

from portbench.metrics._attn_window import read_group


def read(rec):
    return read_group(rec, "attn_bwd")
