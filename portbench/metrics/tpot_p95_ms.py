"""p95 over every request due in the window that completed with at least
two tokens of (finish - first token) / (tokens - 1)."""

from portbench.stats import percentile


def read(rec):
    if rec.get("mode") != "open":
        return None
    per = [(r["finished"] - r["first"]) / (r["tokens"] - 1)
           for r in rec["judged"] if r["status"] == "ok" and r["tokens"] >= 2]
    return None if not per else 1e3 * percentile(per, 95)
