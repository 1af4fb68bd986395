"""Expert layer: device seconds of the operations launched inside the
port's ``moe.*`` spans (``telemetry.MOE_SPANS``), forward and backward,
by the innermost span holding each launch (``spans.device_by_span``, by
time, so the backward's spans on autograd's thread own its launches).
Traced runs only: they arm the spans. A program without the spans reads
nothing."""

from portbench import spans as _spans
from portbench import work


def _moe_spans():
    from tpu_cluster_torch import telemetry
    return getattr(telemetry, "MOE_SPANS", ())


def device_seconds(rec, names, phases=("fwd", "bwd")):
    """Device seconds launched inside spans named ``names`` of the given
    phases, or None where the record holds no such span."""
    if rec.get("kind") != "train" or "timeline" not in rec:
        return None
    moe = set(_moe_spans())
    kept = [s for s in rec["spans"]
            if s.name not in moe or s.args.get("phase") in phases]
    if not rec["timeline"].busy or not any(s.name in names for s in kept):
        return None
    by = _spans.device_by_span(rec["timeline"], kept)
    return sum(by.get(n, 0.0) for n in names)


def moe_share(rec, phases=("fwd", "bwd")):
    """That time over the window's busy seconds, in %."""
    names = _moe_spans()
    seconds = device_seconds(rec, names, phases) if names else None
    if seconds is None:
        return None
    return 100.0 * seconds / rec["timeline"].busy_s


def expert_mfu(rec):
    """The expert products' model work of the window's steps over the
    device seconds inside ``moe.experts`` spans, at the bf16 peak, in %."""
    names = _moe_spans()
    if not names or "expert_flops_per_step" not in rec:
        return None
    seconds = device_seconds(rec, (names[2],))
    if not seconds:
        return None
    return 100.0 * rec["steps"] * rec["expert_flops_per_step"] / (
        seconds * work.PEAK_BF16_FLOPS)
