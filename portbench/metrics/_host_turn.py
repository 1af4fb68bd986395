"""Engine host turn: the mean over the window's decoding iterations (the
engine's ``serving.iteration`` spans with a slot seated) of the span's
length less the device-busy time inside it, in ms
(``spans.host_turn_ms``). Traced runs only: they arm the spans."""

from portbench import spans


def read_mode(rec, mode):
    if rec.get("mode") != mode or "timeline" not in rec:
        return None
    from tpu_cluster_torch import telemetry

    return spans.host_turn_ms(rec["timeline"], rec["spans"],
                              telemetry.SERVING_SPANS[0])
