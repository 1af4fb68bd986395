"""SLO burn-rate evaluation: "is the cluster currently healthy",
answered from the telemetry the stack already produces. The port's own
copy of ``tpu_cluster/slo.py``: the SLOs, their metric families, the
math, the report text and ``to_dict()`` are the reference's (it has no
accelerator content).

The discipline is the SRE-workbook multi-window multi-burn-rate shape
(Beyer et al., "The Site Reliability Workbook", ch. 5): an SLO defines
an error budget (1 - objective); the BURN RATE over a window is the
fraction of that budget the window's error rate consumes per unit time;
an alert fires only when BOTH a short and a long window burn faster
than the severity's factor — the short window gives fast detection, the
long one keeps a brief blip from paging. The classic pairs, kept here:

- **page**: 5m AND 1h both burning > 14.4x (2% of a 30-day budget gone
  in one hour)
- **warn**: 6h AND 3d both burning > 1.0x (budget exhaustion pace)

WHERE THE SAMPLES COME FROM — span-derived, so this runs CLUSTERLESS:
the evaluator consumes Chrome trace files (``tpuctl apply
--trace-out``, the bench's saved arms, a flight-recorder dump) and
turns spans into timestamped good/bad samples per SLO. The SLO
definitions mirror the metric families the registries already export
(``tpuctl_requests_total``, ``tpuctl_watch_reconnects_total``,
``admission-pass`` spans / ``tpuctl_gang_wait_seconds``), but cumulative
counters carry no time axis — spans do, which is what makes windowed
burn rates computable from a finished run.

TIME SYNTHESIS: a test/bench trace lasts seconds, not days, so nominal
window widths are mapped onto the trace: ``scale`` = nominal seconds
represented by one trace second, chosen by default so the LONG PAGE
window (1h) spans the whole trace — the 5m window then reads the most
recent ~1/12th, and the 6h/3d warn windows clamp to the full trace.
Pass an explicit scale to change the mapping; the report records it.

``python -m tpu_cluster_torch slo check TRACE...`` exits 0 when no severity is burning and 1
with the burning window pair named — the CI health gate.

LIVE MODE: the verdict math is factored behind
:data:`SampleSource` — a per-SLO windowed ``(bad, total)`` ratio
callable — so the same multi-window rules also evaluate over SCRAPED
counter increases: ``slo check --live --targets ...`` feeds
sources built by ``metricsdb.live_slo_report`` from a running
ScrapeManager's TSDB (counters gain their time axis from the scrape
timeline), with the identical rc contract and report shape and the
same verdict as the trace-derived path.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, \
    Sequence, Tuple

# One sample: (age_s before the end of its trace's timeline, good)
Sample = Tuple[float, bool]

# One SLO's evidence for windowed ratio queries (the sample-source
# abstraction): called with a window width in SOURCE seconds
# (trace seconds for span-derived samples, TSDB seconds for scraped
# counters), returns ``(bad, total)`` over the most recent window.
# Both checkers share the verdict math through it: `tpuctl slo check`
# wraps span samples (:func:`source_from_samples`), `--live` wraps
# counter increases (metricsdb.live_slo_report).
SampleSource = Callable[[float], Tuple[float, float]]


@dataclass(frozen=True)
class BurnWindow:
    """One multi-window alert rule: both windows must burn faster than
    ``factor`` to fire."""

    severity: str  # "page" | "warn"
    short_s: float  # nominal seconds
    long_s: float
    factor: float

    def label(self) -> str:
        return (f"{self.severity} ({_fmt_window(self.short_s)}/"
                f"{_fmt_window(self.long_s)})")


def _fmt_window(seconds: float) -> str:
    if seconds % 86400 == 0:
        return f"{int(seconds // 86400)}d"
    if seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    return f"{int(seconds // 60)}m"


# The SRE-workbook pairs (fast 5m/1h page, slow 6h/3d warn).
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow("page", 300.0, 3600.0, 14.4),
    BurnWindow("warn", 6 * 3600.0, 3 * 24 * 3600.0, 1.0),
)

# The long-page window is the synthesis anchor: scale maps it onto the
# whole trace by default (see module docstring).
_ANCHOR_WINDOW_S = 3600.0

# Admission-decision latency threshold: a pass slower than this spends
# error budget (the families the gauge mirrors put decision latency in
# whole seconds; one second is generous for an O(events) pass).
ADMISSION_LATENCY_THRESHOLD_S = 1.0


@dataclass(frozen=True)
class SLODef:
    """One service-level objective over span-derived samples.

    ``families`` names the exported metric families whose semantics the
    extractor mirrors — the docs/debugging pointer from a burning SLO
    back to the live registries."""

    name: str
    description: str
    objective: float  # e.g. 0.99 -> 1% error budget
    families: Tuple[str, ...]


DEFAULT_SLOS: Tuple[SLODef, ...] = (
    SLODef(
        "apply-availability",
        "non-watch apiserver round trips that answered (no transport-0 "
        "loss, no 5xx, no 429 shed)",
        0.99,
        ("tpuctl_requests_total", "fake_apiserver_requests_total")),
    SLODef(
        "watch-uptime",
        "watch stream opens that were accepted (a denied/failed open is "
        "a readiness-signal outage)",
        0.99,
        ("tpuctl_watch_reconnects_total", "tpuctl_requests_total")),
    SLODef(
        "admission-latency",
        f"admission passes deciding within "
        f"{ADMISSION_LATENCY_THRESHOLD_S:g}s",
        0.99,
        ("tpuctl_gang_wait_seconds", "tpu_operator_sync_lag_seconds")),
)


def _complete_spans(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("not a Chrome trace: no traceEvents array")
    return [e for e in events
            if isinstance(e, dict) and e.get("ph") == "X"]


def _span_end_s(e: Dict[str, Any]) -> float:
    return (float(e.get("ts", 0.0)) + float(e.get("dur", 0.0))) / 1e6


def _is_bad_status(status: Any) -> bool:
    try:
        code = int(status)
    except (TypeError, ValueError):
        return True  # an unparseable status is not a served request
    return code == 0 or code == 429 or code >= 500


def samples_for(slo: SLODef, trace: Dict[str, Any]) -> List[Sample]:
    """``(age_s, good)`` samples for one SLO from one trace — ages are
    seconds before the trace's LAST span end, so "recent" aligns across
    traces from different processes."""
    spans = _complete_spans(trace)
    if not spans:
        return []
    horizon = max(_span_end_s(e) for e in spans)
    out: List[Sample] = []
    for e in spans:
        args = e.get("args") or {}
        cat = e.get("cat")
        good: Optional[bool] = None
        if slo.name == "apply-availability":
            if cat == "http" and not args.get("watch"):
                good = not _is_bad_status(args.get("status"))
        elif slo.name == "watch-uptime":
            if cat == "http" and args.get("watch"):
                # a watch open either streamed (200) or it did not —
                # any refusal (403/410/transport) is readiness-signal
                # downtime, unlike plain requests where 4xx is an answer
                good = args.get("status") == 200
        elif slo.name == "admission-latency":
            if cat == "admission" and e.get("name") == "admission-pass":
                good = (float(e.get("dur", 0.0)) / 1e6
                        <= ADMISSION_LATENCY_THRESHOLD_S)
        if good is not None:
            out.append((max(0.0, horizon - _span_end_s(e)), good))
    return out


@dataclass(frozen=True)
class WindowVerdict:
    severity: str
    short_s: float
    long_s: float
    factor: float
    burn_short: float
    burn_long: float
    samples_short: int
    samples_long: int
    burning: bool

    def to_dict(self) -> Dict[str, Any]:
        return {"severity": self.severity, "short_s": self.short_s,
                "long_s": self.long_s, "factor": self.factor,
                "burn_short": round(self.burn_short, 3),
                "burn_long": round(self.burn_long, 3),
                "samples_short": self.samples_short,
                "samples_long": self.samples_long,
                "burning": self.burning}


@dataclass(frozen=True)
class SLOVerdict:
    slo: SLODef
    windows: Tuple[WindowVerdict, ...]
    total_samples: int

    @property
    def burning(self) -> bool:
        return any(w.burning for w in self.windows)

    def burning_labels(self) -> List[str]:
        return [BurnWindow(w.severity, w.short_s, w.long_s,
                           w.factor).label()
                for w in self.windows if w.burning]

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.slo.name, "objective": self.slo.objective,
                "families": list(self.slo.families),
                "samples": self.total_samples,
                "burning": self.burning,
                "windows": [w.to_dict() for w in self.windows]}


@dataclass(frozen=True)
class SLOReport:
    verdicts: Tuple[SLOVerdict, ...]
    scale: float  # nominal seconds per trace second
    trace_span_s: float

    @property
    def ok(self) -> bool:
        return not any(v.burning for v in self.verdicts)

    def to_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok, "scale": round(self.scale, 3),
                "trace_span_s": round(self.trace_span_s, 3),
                "slos": [v.to_dict() for v in self.verdicts]}


def source_from_samples(samples: Sequence[Sample]) -> SampleSource:
    """The span-derived :data:`SampleSource`: ``(bad, total)`` counts
    of the samples no older than the window."""
    def ratio(window_s: float) -> Tuple[float, float]:
        recent = [good for age, good in samples if age <= window_s]
        return (float(sum(1 for good in recent if not good)),
                float(len(recent)))
    return ratio


def _empty_source(window_s: float) -> Tuple[float, float]:
    """The no-evidence source: burn 0 with a visible zero count (an SLO
    the live mapping cannot express must read 'ok (no samples)', never
    silently green-with-confidence)."""
    return 0.0, 0.0


def evaluate_sources(sources: Mapping[str, SampleSource],
                     slos: Sequence[SLODef] = DEFAULT_SLOS,
                     windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
                     scale: Optional[float] = None,
                     span_s: float = 0.0) -> SLOReport:
    """Evaluate every SLO x window pair against per-SLO ratio SOURCES —
    the shared verdict math under both `tpuctl slo check` paths (span
    samples and live scraped counters). ``scale`` maps nominal window
    seconds onto source seconds; default anchors the long page window
    (1h) to ``span_s``. No evidence in a window -> burn 0 with the
    count carried, so 'no data' stays visible in the report."""
    if scale is None:
        scale = _ANCHOR_WINDOW_S / max(span_s, 1e-6)
    verdicts: List[SLOVerdict] = []
    for slo in slos:
        src = sources.get(slo.name, _empty_source)
        budget = max(1.0 - slo.objective, 1e-9)
        wvs: List[WindowVerdict] = []
        for w in windows:
            bad_s, n_short = src(w.short_s / scale)
            bad_l, n_long = src(w.long_s / scale)
            burn_short = (bad_s / n_short) / budget if n_short else 0.0
            burn_long = (bad_l / n_long) / budget if n_long else 0.0
            wvs.append(WindowVerdict(
                severity=w.severity, short_s=w.short_s, long_s=w.long_s,
                factor=w.factor, burn_short=burn_short,
                burn_long=burn_long, samples_short=int(round(n_short)),
                samples_long=int(round(n_long)),
                burning=(burn_short > w.factor
                         and burn_long > w.factor)))
        total = src(float("inf"))[1]
        verdicts.append(SLOVerdict(slo=slo, windows=tuple(wvs),
                                   total_samples=int(round(total))))
    return SLOReport(verdicts=tuple(verdicts), scale=float(scale),
                     trace_span_s=span_s)


def evaluate(traces: Sequence[Dict[str, Any]],
             slos: Sequence[SLODef] = DEFAULT_SLOS,
             windows: Sequence[BurnWindow] = DEFAULT_WINDOWS,
             scale: Optional[float] = None) -> SLOReport:
    """Evaluate every SLO x window pair over the pooled span samples of
    ``traces``. ``scale`` maps nominal window seconds onto trace
    seconds; default anchors the long page window (1h) to the full
    trace span."""
    if not traces:
        raise ValueError("slo.evaluate: no input traces")
    span_s = 0.0
    per_slo: Dict[str, List[Sample]] = {s.name: [] for s in slos}
    for doc in traces:
        spans = _complete_spans(doc)  # raises on a non-trace
        if spans:
            span_s = max(span_s,
                         max(_span_end_s(e) for e in spans)
                         - min(float(e.get("ts", 0.0)) / 1e6
                               for e in spans))
        for slo in slos:
            per_slo[slo.name].extend(samples_for(slo, doc))
    sources = {name: source_from_samples(samples)
               for name, samples in per_slo.items()}
    return evaluate_sources(sources, slos=slos, windows=windows,
                            scale=scale, span_s=span_s)


def format_report(report: SLOReport) -> str:
    """The `tpuctl slo check` table: one block per SLO, one line per
    window pair, burning pairs marked."""
    lines: List[str] = [
        f"slo check: trace span {report.trace_span_s:.2f}s, scale "
        f"{report.scale:.1f} nominal s / trace s"]
    for v in report.verdicts:
        state = "BURNING" if v.burning else (
            "ok" if v.total_samples else "ok (no samples)")
        lines.append(f"{v.slo.name} (objective "
                     f"{v.slo.objective:.4g}): {state}")
        for w in v.windows:
            mark = "BURNING" if w.burning else "ok"
            lines.append(
                f"  {w.severity:<5} {_fmt_window(w.short_s)}/"
                f"{_fmt_window(w.long_s)}  burn "
                f"{w.burn_short:7.2f}x / {w.burn_long:7.2f}x  "
                f"(> {w.factor:g}x fires; "
                f"{w.samples_short}/{w.samples_long} samples)  {mark}")
    lines.append("slo check: " + ("all budgets healthy" if report.ok
                                  else "error budget burning — "
                                  + "; ".join(
                                      f"{v.slo.name}: "
                                      + ", ".join(v.burning_labels())
                                      for v in report.verdicts
                                      if v.burning)))
    return "\n".join(lines)


def load_trace(path: str) -> Dict[str, Any]:
    """Read one Chrome trace JSON document (ValueError on junk — the
    CLI turns it into a clean exit 2)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: top-level JSON is not an object")
    return doc
