"""Decode step: the share of the rows the window's decodes attended whose
keys and values came from the cache rather than a projection, in %:
100 x sum(cached_rows) / sum(cached_rows + projected_rows) over the
engine's ``serving.dispatch`` spans inside the traced window. ``None``
where no such span carries both annotations (a decode that keeps no
cache). Traced runs only: they arm the spans."""


def read_mode(rec, mode):
    if rec.get("mode") != mode or "timeline" not in rec:
        return None
    from tpu_cluster_torch import telemetry

    dispatch = telemetry.SERVING_SPANS[4]
    w0, w1 = rec["timeline"].window
    cached = projected = 0
    for s in rec["spans"]:
        if s.name == dispatch and w0 <= s.start and s.end <= w1 \
                and "cached_rows" in s.args and "projected_rows" in s.args:
            cached += s.args["cached_rows"]
            projected += s.args["projected_rows"]
    total = cached + projected
    return 100.0 * cached / total if total else None
