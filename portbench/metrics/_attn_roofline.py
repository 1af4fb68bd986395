"""Kernels: causal attention's model work for the window's training
steps over the least time the card could take for it against the device
time of the kernels named under ``kernel_names/<group>/``."""

from portbench import work
from portbench.trace import kernel_names

COUNTS = {"attn_fwd": (work.attn_fwd_flops, work.attn_fwd_bytes),
          "attn_bwd": (work.attn_bwd_flops, work.attn_bwd_bytes)}


def read_group(rec, group):
    if rec.get("kind") != "train" or rec.get("trace") is None:
        return None
    launches, seconds = rec["trace"].matching(kernel_names(group))
    if not launches or seconds <= 0:
        return None
    flops, nbytes = COUNTS[group]
    passes = rec["steps"] * rec["layers"]
    shape = rec["attn_shape"]
    return work.roofline_share(passes * flops(*shape), passes * nbytes(*shape),
                               seconds)
