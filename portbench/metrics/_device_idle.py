"""Device: the share of the traced window in which no operation runs on
the card (the union of the trace's device intervals)."""


def read_kind(rec, kind, mode=None):
    if rec.get("kind") != kind or rec.get("trace") is None \
            or (mode is not None and rec.get("mode") != mode):
        return None
    t = rec["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
