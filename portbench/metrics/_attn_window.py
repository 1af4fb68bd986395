"""Kernels: the attention work of the window's training steps over the
pairs each layer's mask admits (a sliding layer's window, a full layer's
causal triangle; ``work_sparse``), as the least time the card could take
for it, against the device time of the kernels named under
``kernel_names/<group>/``."""

from portbench import work
from portbench.trace import kernel_names


def read_group(rec, group):
    key = f"{group}_flops_per_step"
    if rec.get("kind") != "train" or rec.get("trace") is None \
            or key not in rec:
        return None
    launches, seconds = rec["trace"].matching(kernel_names(group))
    if not launches or seconds <= 0:
        return None
    return work.roofline_share(rec["steps"] * rec[key],
                               rec["steps"] * rec[f"{group}_bytes_per_step"],
                               seconds)
