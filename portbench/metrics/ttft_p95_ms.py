"""p95 over every request due in the window of first token minus the
time it was due; a rejected request, a missed deadline or no first
token by the end of the drain is a miss, at +inf."""

from portbench.stats import MISS, percentile


def read(rec):
    if rec.get("mode") != "open" or not rec["judged"]:
        return None
    return 1e3 * percentile(
        (r["first"] - r["due"] if r["status"] == "ok" else MISS
         for r in rec["judged"]), 95)
