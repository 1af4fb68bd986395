"""Trainer: the closed-form model work of the steps completed in the
traced window over that window, at the bf16 peak."""

from portbench import work


def read(rec):
    if rec.get("kind") != "train" or rec.get("trace") is None:
        return None
    return 100.0 * rec["steps"] * rec["flops_per_step"] / (
        rec["trace"].window_s * work.PEAK_BF16_FLOPS)
