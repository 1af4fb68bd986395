"""Decode step: the model work of the tokens emitted in the window (each
as if keys and values were cached: ``work.served_token_flops`` at its
context) over the device's busy time in the traced window, at the bf16
peak."""

from portbench import work


def read_mode(rec, mode):
    if rec.get("mode") != mode or rec.get("trace") is None \
            or not rec["window_ctx"] or rec["trace"].busy_s <= 0:
        return None
    m = rec["model"]
    flops = sum(work.served_token_flops(m["d_model"], m["d_ff"], m["vocab"],
                                        ctx) for ctx in rec["window_ctx"])
    return 100.0 * flops / (rec["trace"].busy_s * work.PEAK_BF16_FLOPS)
