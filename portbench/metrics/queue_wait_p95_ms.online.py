"""Engine admission: p95 over the requests due in the window of the
engine's admission stamp minus the time due; never admitted is +inf."""

from portbench.stats import MISS, percentile


def read(rec):
    if rec.get("mode") != "open" or not rec["judged"]:
        return None
    return 1e3 * percentile(
        (r["admitted"] - r["due"] if r["admitted"] is not None else MISS
         for r in rec["judged"]), 95)
