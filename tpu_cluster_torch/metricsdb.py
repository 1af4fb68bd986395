"""Continuous metrics: scrape pipeline, time-series store, live SLO
sources and the terminal dashboard — stdlib only. The port's own copy
of ``tpu_cluster/metricsdb.py``, whole: the four layers and
``MetricsServer``, a registry behind a daemon-threaded ``/metrics``
endpoint.

PARSER — :func:`parse_text` reads Prometheus text exposition into flat
``{(name, sorted label pairs): value}`` samples plus the ``# TYPE`` /
``# HELP`` tables: the read twin of ``MetricsRegistry.render()``, held
by ``parse_text(reg.render()).samples == reg.samples()``, escaped label
values decoded via ``telemetry.unescape_label``.

TSDB — :class:`TSDB` holds bounded per-series sample rings (wall-clock
retention window, monotonic timestamps, staleness on instant reads)
with a small query layer: :meth:`TSDB.latest` instant lookups,
:meth:`TSDB.increase`/:meth:`TSDB.rate` with counter-RESET handling (a
restarted target's counter dropping to zero contributes its new value,
never a negative rate), :meth:`TSDB.histogram_quantile` over the fixed
cumulative-``le`` buckets, and :func:`aggregate` (sum/avg/max) across
label sets. :meth:`TSDB.dump`/:meth:`TSDB.load` snapshot the store as
JSON — the replay surface ``dash --once --replay`` renders from.

SCRAPER — :class:`ScrapeManager` polls N HTTP targets (a serving
replica's ``/metrics``, Python control loops serving their registries
via :class:`MetricsServer`) on an interval from one daemon thread, each
scrape one wall-bounded attempt through ``kubeapply.Client.get_raw``.
HARD fail-open: a dead/garbled target is DATA — ``up{job=...} 0`` —
never an exception, and the loop never blocks past the wall. Every
scrape synthesizes the self-metrics ``up``,
``tpuctl_scrape_duration_seconds`` and ``tpuctl_scrape_samples_total``
into the TSDB (and the attached telemetry registry, when armed).

LIVE SLO — :func:`live_slo_report` maps the ``slo.SLODef`` burn-rate
rules onto scraped counter RATIOS: windowed bad/total increases of the
code-labeled request counters become ``slo.SampleSource`` callables,
evaluated by ``slo.evaluate_sources`` with the same multi-window
verdicts and rc contract as the span-derived path. SLOs whose evidence
has no live counter expression (watch-uptime, admission-latency: the
registries export no good/bad split for them) report zero samples —
visibly 'ok (no samples)', never silently green.

DASH — :func:`render_dash` draws one deterministic terminal frame over
the TSDB: per-target ``up``, request/error rates, p99 latency,
sparklines, the serving panel (decoded tok/s, queue depth, the
autoscaler's replicas), event counts. ``dash`` redraws it per interval;
``--once --replay FILE`` renders a byte-exact frame from a dumped TSDB.
The frame keeps the reference's ``tpuctl dash`` header.

Concurrency: every lock here is LEAF-ONLY: ``TSDB._lock`` guards the
series map and is never held across I/O, parsing or telemetry;
``ScrapeManager._lock`` guards scrape accounting only — the wire
attempt, the parse and the TSDB ingest all happen outside it.
"""

from __future__ import annotations

import math
import re
import socket
import threading
import time
import urllib.parse
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Deque, Dict, List, Mapping, \
    Optional, Sequence, Tuple

from . import kubeapply, slo as _slo, telemetry as _telemetry
from .telemetry import LabelPairs

# One exposition sample's identity: (metric name, sorted label pairs).
SampleKey = Tuple[str, LabelPairs]

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")


# --------------------------------------------------------------------------
# Parser: the read twin of MetricsRegistry.render().


class ParsedScrape:
    """One parsed exposition document: flat ``samples`` (histograms
    stay expanded as their ``_bucket``/``_sum``/``_count`` rows, the
    cumulative-``le`` encoding preserved), family ``types`` from
    ``# TYPE`` lines, ``helps`` from ``# HELP`` lines."""

    def __init__(self, samples: Dict[SampleKey, float],
                 types: Dict[str, str], helps: Dict[str, str]) -> None:
        self.samples = samples
        self.types = types
        self.helps = helps


def _parse_sample_line(line: str, lineno: int
                       ) -> Tuple[str, LabelPairs, float]:
    """``name{k="v",...} value [timestamp]`` -> (name, sorted pairs,
    value). Label values decode the exposition escapes
    (telemetry.unescape_label); a trailing Prometheus timestamp token
    is tolerated and ignored (nothing in-repo emits one)."""
    m = _NAME_RE.match(line)
    if m is None:
        raise ValueError(f"line {lineno}: no metric name in {line!r}")
    name = m.group(0)
    i = m.end()
    n = len(line)
    labels: List[Tuple[str, str]] = []
    if i < n and line[i] == "{":
        i += 1
        while True:
            while i < n and line[i] in " \t":
                i += 1
            if i < n and line[i] == "}":
                i += 1
                break
            lm = _LABEL_NAME_RE.match(line, i)
            if lm is None:
                raise ValueError(
                    f"line {lineno}: bad label name at col {i}")
            lname = lm.group(0)
            i = lm.end()
            if i >= n or line[i] != "=":
                raise ValueError(
                    f"line {lineno}: expected '=' after label "
                    f"{lname!r}")
            i += 1
            if i >= n or line[i] != '"':
                raise ValueError(
                    f"line {lineno}: label {lname!r} value is not "
                    f"quoted")
            i += 1
            buf: List[str] = []
            while True:
                if i >= n:
                    raise ValueError(
                        f"line {lineno}: unterminated label value")
                c = line[i]
                if c == "\\":
                    if i + 1 >= n:
                        raise ValueError(
                            f"line {lineno}: dangling escape")
                    # raw two-char escape; decoded in one pass below so
                    # the \\ vs \n precedence matches the writer
                    buf.append(line[i:i + 2])
                    i += 2
                    continue
                if c == '"':
                    i += 1
                    break
                buf.append(c)
                i += 1
            labels.append((lname,
                           _telemetry.unescape_label("".join(buf))))
            while i < n and line[i] in " \t":
                i += 1
            if i < n and line[i] == ",":
                i += 1
                continue
            if i < n and line[i] == "}":
                i += 1
                break
            raise ValueError(
                f"line {lineno}: expected ',' or '}}' in label set")
    rest = line[i:].strip()
    if not rest:
        raise ValueError(f"line {lineno}: sample has no value")
    token = rest.split()[0]
    try:
        value = float(token)
    except ValueError:
        raise ValueError(
            f"line {lineno}: not a sample value: {token!r}") from None
    return name, tuple(sorted(labels)), value


def parse_text(text: str) -> ParsedScrape:
    """Parse one Prometheus text-exposition document. Raises ValueError
    (naming the line) on malformed input — the ScrapeManager classifies
    that as a failed scrape (``up 0``), exactly like a dead socket."""
    samples: Dict[SampleKey, float] = {}
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                types[parts[2]] = parts[3] if len(parts) > 3 else ""
            elif len(parts) >= 3 and parts[1] == "HELP":
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue  # other comments are legal exposition noise
        name, pairs, value = _parse_sample_line(line, lineno)
        samples[(name, pairs)] = value  # duplicate key: last one wins
    return ParsedScrape(samples, types, helps)


# --------------------------------------------------------------------------
# TSDB: bounded per-series rings + the query layer.


def _counterish(name: str, types: Mapping[str, str]) -> bool:
    """Is this sample row monotonic (zero-baseline eligible)? Counter
    families directly; a histogram's expanded ``_bucket``/``_count``/
    ``_sum`` rows via their base family's TYPE. Unknown families are
    NOT counterish — a synthetic zero under a gauge would fabricate
    rate where none exists."""
    if types.get(name) == "counter":
        return True
    for suffix in ("_bucket", "_count", "_sum"):
        if name.endswith(suffix) and \
                types.get(name[:-len(suffix)]) == "histogram":
            return True
    return False


def aggregate(values: Mapping[LabelPairs, float],
              how: str = "sum") -> float:
    """Aggregate one query's per-series results across label sets:
    ``sum`` | ``avg`` | ``max`` (0.0 for no series — queries stay
    total like MetricsRegistry.total)."""
    vals = list(values.values())
    if not vals:
        return 0.0
    if how == "sum":
        return float(sum(vals))
    if how == "avg":
        return float(sum(vals) / len(vals))
    if how == "max":
        return float(max(vals))
    raise ValueError(f"unknown aggregation {how!r} (sum|avg|max)")


class TSDB:
    """Bounded in-memory time-series store for scraped samples.

    Per-series sample rings (``max_samples_per_series`` hard bound plus
    a wall-clock ``retention_s`` window pruned on ingest) keyed by
    ``(name, sorted label pairs)``. Timestamps come from ``clock``
    (monotonic seconds by default; injectable for deterministic tests
    and frozen by :meth:`load` for replay) — instant reads apply
    ``staleness_s`` against it, so a series whose target died stops
    answering instead of reporting its last value forever.
    """

    def __init__(self, retention_s: float = 600.0,
                 max_samples_per_series: int = 4096,
                 staleness_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.retention_s = float(retention_s)
        self.max_samples_per_series = max(2, int(max_samples_per_series))
        self.staleness_s = float(staleness_s)
        self._clock = clock
        self._lock: Any = threading.Lock()
        # series key -> ring of (ts, value), oldest first
        self._series: Dict[SampleKey, Deque[Tuple[float, float]]] = {}  # guarded-by: _lock
        # family name -> counter|gauge|histogram (last scrape wins)
        self._types: Dict[str, str] = {}  # guarded-by: _lock

    # ------------------------------------------------------------ writes

    def now(self) -> float:
        return float(self._clock())

    def append(self, name: str, labels: Mapping[str, str], value: float,
               ts: Optional[float] = None, mtype: str = "") -> None:
        """Append one sample to one series (synthesized self-metrics
        ride this; scrapes ride :meth:`ingest`)."""
        key: SampleKey = (name, tuple(sorted(labels.items())))
        t = self.now() if ts is None else float(ts)
        with self._lock:
            self._append_locked(key, t, float(value))
            if mtype:
                self._types[name] = mtype

    # requires: self._lock
    def _append_locked(self, key: SampleKey, ts: float,
                       value: float) -> None:
        ring = self._series.get(key)
        if ring is None:
            new_ring: Deque[Tuple[float, float]] = deque(
                maxlen=self.max_samples_per_series)
            self._series[key] = new_ring
            ring = new_ring
        ring.append((ts, value))

    def ingest(self, scrape: ParsedScrape,
               labels: Optional[Mapping[str, str]] = None,
               ts: Optional[float] = None,
               zero_baseline_ts: Optional[float] = None) -> int:
        """Ingest one parsed scrape, merging ``labels`` (the scrape
        manager's ``job=``) into every sample's label set — extra
        labels win on collision, the Prometheus relabeling convention.
        Prunes the retention window afterwards. Returns the sample
        count ingested.

        ``zero_baseline_ts`` (the scrape manager passes its previous
        successful scrape's timestamp): a COUNTER-family series first
        seen now, while the target was already under observation, was
        genuinely zero a scrape ago — exposition omits zero-valued
        series, so a burst landing entirely on a brand-new label set
        (the first 503 of a path) would otherwise never register as an
        increase. Such series get one synthetic ``(baseline_ts, 0)``
        sample ahead of their first real one. Gauges never do, and
        neither does anything on the FIRST scrape of a target (a
        long-running server's pre-existing totals are history, not
        increase).

        Label collisions follow the Prometheus convention: a source
        label the scrape manager also sets (a target that itself
        exports ``job=`` — e.g. a registry holding ANOTHER scrape
        manager's self-metrics) is RENAMED to ``exported_<label>``,
        never overwritten — overwriting would collapse distinct
        scraped series into one ring, whose interleaved values the
        counter-reset heuristic then misreads as resets, fabricating
        increases."""
        t = self.now() if ts is None else float(ts)
        extra = dict(labels or {})
        rows: List[Tuple[SampleKey, float, bool]] = []
        for (name, pairs), value in scrape.samples.items():
            merged = dict(pairs)
            for key, val in extra.items():
                if key in merged and merged[key] != val:
                    merged[f"exported_{key}"] = merged.pop(key)
                merged[key] = val
            rows.append(((name, tuple(sorted(merged.items()))), value,
                         _counterish(name, scrape.types)))
        with self._lock:
            for key, value, counterish in rows:
                if zero_baseline_ts is not None and counterish \
                        and key not in self._series:
                    self._append_locked(key, float(zero_baseline_ts),
                                        0.0)
                self._append_locked(key, t, value)
            self._types.update(scrape.types)
            self._prune_locked(t)
        return len(rows)

    # requires: self._lock
    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.retention_s
        dead: List[SampleKey] = []
        for key, ring in self._series.items():
            while ring and ring[0][0] < cutoff:
                ring.popleft()
            if not ring:
                dead.append(key)
        for key in dead:
            del self._series[key]

    # ------------------------------------------------------------ reads

    def _snapshot(self, name: str, label_filter: Mapping[str, str]
                  ) -> List[Tuple[LabelPairs, List[Tuple[float, float]]]]:
        """Copy matching series under one lock hold; all query math
        happens on the copy, outside the lock (leaf-only)."""
        want = set(label_filter.items())
        out: List[Tuple[LabelPairs, List[Tuple[float, float]]]] = []
        with self._lock:
            for (n, pairs), ring in self._series.items():
                if n != name or not want <= set(pairs):
                    continue
                out.append((pairs, list(ring)))
        return out

    def family_type(self, name: str) -> str:
        with self._lock:
            return self._types.get(name, "")

    def has_series(self, name: str) -> bool:
        """Does ANY series of this family exist in the store? (the
        live SLO's once-per-source family selection)."""
        with self._lock:
            return any(n == name for n, _pairs in self._series)

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({n for n, _pairs in self._series})

    def label_values(self, name: str, label: str) -> List[str]:
        """Sorted distinct values of ``label`` across a family's series
        (the dash's job discovery)."""
        with self._lock:
            keys = [pairs for n, pairs in self._series if n == name]
        return sorted({dict(pairs)[label] for pairs in keys
                       if label in dict(pairs)})

    def latest(self, name: str, now: Optional[float] = None,
               **label_filter: str) -> Dict[LabelPairs, float]:
        """Instant lookup: each matching series' newest sample, with
        STALENESS applied — a series whose last sample is older than
        ``staleness_s`` is absent from the answer, not frozen at its
        final value."""
        t = self.now() if now is None else now
        out: Dict[LabelPairs, float] = {}
        for pairs, samples in self._snapshot(name, label_filter):
            if not samples:
                continue
            ts, value = samples[-1]
            if t - ts > self.staleness_s:
                continue
            out[pairs] = value
        return out

    def window(self, name: str, window_s: float,
               now: Optional[float] = None,
               **label_filter: str
               ) -> Dict[LabelPairs, List[Tuple[float, float]]]:
        """Range lookup: each matching series' samples inside
        ``[now - window_s, now]``, oldest first — bounded at BOTH ends,
        so a query anchored in the past (the dash's per-slot rates)
        never sees samples from its future."""
        t = self.now() if now is None else now
        start = t - window_s
        out: Dict[LabelPairs, List[Tuple[float, float]]] = {}
        for pairs, samples in self._snapshot(name, label_filter):
            recent = [(ts, v) for ts, v in samples if start <= ts <= t]
            if recent:
                out[pairs] = recent
        return out

    @staticmethod
    def _increase_over(samples: Sequence[Tuple[float, float]]) -> float:
        """Counter increase over consecutive samples with RESET
        handling: a drop (restarted target re-counting from zero)
        contributes the post-reset value, never a negative delta — the
        'restart must not produce a negative rate' pin."""
        inc = 0.0
        for (_, prev), (_, cur) in zip(samples, samples[1:]):
            inc += cur - prev if cur >= prev else cur
        return inc

    @staticmethod
    def _window_slice(samples: Sequence[Tuple[float, float]],
                      start: float, end: float, staleness_s: float
                      ) -> List[Tuple[float, float]]:
        """One series' samples inside ``[start, end]`` INCLUDING the
        last pre-window sample as baseline (the Prometheus lookback
        shape): an increase needs a reference point, and a window
        narrower than one scrape interval would otherwise never see
        one. The lookback is CAPPED at ``staleness_s`` — an unbounded
        baseline would book a whole scrape-gap's worth of increase
        into an arbitrarily narrow window (a burst that ended minutes
        ago must not page the live SLO's short window). ONE definition
        shared by the query layer and the dash's single-fetch slot
        loop, so the lookback rule cannot drift."""
        recent = [(ts, v) for ts, v in samples if start <= ts <= end]
        before = [(ts, v) for ts, v in samples if ts < start]
        if before and start - before[-1][0] <= staleness_s:
            recent = [before[-1]] + recent
        return recent

    @staticmethod
    def _slice_rate(samples: Sequence[Tuple[float, float]]
                    ) -> Optional[float]:
        """Reset-aware per-second rate over one already-sliced sample
        run (increase / observed span; None = not computable)."""
        if len(samples) < 2:
            return None
        span = samples[-1][0] - samples[0][0]
        if span <= 0:
            return None
        return TSDB._increase_over(samples) / span

    def _windowed(self, name: str, window_s: float, now: Optional[float],
                  label_filter: Mapping[str, str]
                  ) -> Dict[LabelPairs, List[Tuple[float, float]]]:
        """Per-series :meth:`_window_slice` over the most recent
        ``window_s`` seconds (series with fewer than two usable
        samples cannot testify and are absent)."""
        t = self.now() if now is None else now
        start = t - window_s
        out: Dict[LabelPairs, List[Tuple[float, float]]] = {}
        for pairs, samples in self._snapshot(name, label_filter):
            recent = self._window_slice(samples, start, t,
                                        self.staleness_s)
            if len(recent) >= 2:
                out[pairs] = recent
        return out

    def increase(self, name: str, window_s: float,
                 now: Optional[float] = None,
                 **label_filter: str) -> Dict[LabelPairs, float]:
        """Per-series counter increase over the window (reset-aware;
        a series needs at least two observations to testify)."""
        return {pairs: self._increase_over(samples)
                for pairs, samples in self._windowed(
                    name, window_s, now, label_filter).items()}

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None,
             **label_filter: str) -> Dict[LabelPairs, float]:
        """Per-series per-second rate over the window: increase divided
        by the observed sample span (not the nominal window — half-full
        windows must not halve the rate)."""
        out: Dict[LabelPairs, float] = {}
        for pairs, samples in self._windowed(name, window_s, now,
                                             label_filter).items():
            value = self._slice_rate(samples)
            if value is not None:
                out[pairs] = value
        return out

    def histogram_quantile(self, q: float, name: str,
                           window_s: Optional[float] = None,
                           now: Optional[float] = None,
                           **label_filter: str) -> Optional[float]:
        """``histogram_quantile(q, name)`` over the family's cumulative
        ``le`` buckets, summed across matching label sets: instant
        bucket values by default, windowed bucket INCREASES with
        ``window_s`` (the 'p99 over the last minute' form). Linear
        interpolation inside the bucket, Prometheus-style; a rank
        landing in ``+Inf`` answers the highest finite bound. None =
        no observations."""
        bucket = f"{name}_bucket"
        if window_s is None:
            per_series = self.latest(bucket, now=now, **label_filter)
        else:
            per_series = self.increase(bucket, window_s, now=now,
                                       **label_filter)
        by_le: Dict[float, float] = {}
        for pairs, value in per_series.items():
            le = dict(pairs).get("le")
            if le is None:
                continue
            try:
                bound = float(le)
            except ValueError:
                continue
            by_le[bound] = by_le.get(bound, 0.0) + value
        if not by_le or math.inf not in by_le:
            return None
        total = by_le[math.inf]
        if total <= 0:
            return None
        rank = max(0.0, min(1.0, q)) * total
        prev_bound = 0.0
        prev_cum = 0.0
        highest_finite = max((b for b in by_le if not math.isinf(b)),
                             default=0.0)
        for bound in sorted(by_le):
            cum = by_le[bound]
            if cum >= rank:
                if math.isinf(bound):
                    return highest_finite
                if cum <= prev_cum:
                    return bound
                return prev_bound + (bound - prev_bound) * \
                    (rank - prev_cum) / (cum - prev_cum)
            if not math.isinf(bound):
                prev_bound, prev_cum = bound, cum
        return highest_finite

    def span_s(self) -> float:
        """Oldest-to-newest sample distance across every series — the
        observed scrape timeline the live SLO scale anchors on."""
        with self._lock:
            rings = [ring for ring in self._series.values() if ring]
            if not rings:
                return 0.0
            oldest = min(ring[0][0] for ring in rings)
            newest = max(ring[-1][0] for ring in rings)
        return max(0.0, newest - oldest)

    # ------------------------------------------------------- dump / load

    def dump(self) -> Dict[str, Any]:
        """The store as one JSON-ready document (a dashboard replay
        reads it back): config (ring bound included, so a replay can
        never silently truncate what the live store held), family
        types, and every series with its (ts, value) samples."""
        with self._lock:
            series = [{"name": name, "labels": dict(pairs),
                       "samples": [[ts, v] for ts, v in ring]}
                      for (name, pairs), ring in
                      sorted(self._series.items())]
            types = dict(self._types)
        return {"retention_s": self.retention_s,
                "staleness_s": self.staleness_s,
                "max_samples_per_series": self.max_samples_per_series,
                "types": types, "series": series}

    @classmethod
    def load(cls, doc: Mapping[str, Any]) -> "TSDB":
        """Rebuild a TSDB from :meth:`dump` output with the clock
        FROZEN at the newest recorded timestamp — replay is
        deterministic by construction (staleness, windows and rates
        all see the instant the dump captured). ValueError on ANY
        malformed document — the rc-2 contract the dash CLI's error
        path relies on (a junk replay file must never traceback)."""
        if not isinstance(doc, Mapping):
            raise ValueError("not a TSDB dump: top-level JSON is not "
                             "an object")
        series = doc.get("series")
        if not isinstance(series, list):
            raise ValueError("not a TSDB dump: no series array")
        try:
            newest = 0.0
            for s in series:
                for ts, _v in s.get("samples") or []:
                    newest = max(newest, float(ts))
            frozen = newest
            tsdb = cls(retention_s=float(doc.get("retention_s", 600.0)),
                       staleness_s=float(doc.get("staleness_s", 30.0)),
                       max_samples_per_series=int(doc.get(
                           "max_samples_per_series", 4096)),
                       clock=lambda: frozen)
            with tsdb._lock:
                tsdb._types.update({str(k): str(v) for k, v in
                                    (doc.get("types") or {}).items()})
            for s in series:
                name = str(s.get("name", ""))
                labels = {str(k): str(v)
                          for k, v in (s.get("labels") or {}).items()}
                for ts, v in s.get("samples") or []:
                    tsdb.append(name, labels, float(v), ts=float(ts))
        except (TypeError, ValueError, AttributeError) as exc:
            raise ValueError(f"not a TSDB dump: {exc}") from exc
        return tsdb


# --------------------------------------------------------------------------
# Scrape manager.


class Target:
    """One scrape target: ``job`` labels every ingested sample,
    ``url`` is the full exposition endpoint."""

    def __init__(self, job: str, url: str) -> None:
        split = urllib.parse.urlsplit(url)
        if split.scheme not in ("http", "https") or not split.netloc:
            raise ValueError(f"target {job!r}: not an http(s) URL: "
                             f"{url!r}")
        self.job = job
        self.url = url
        self.base_url = f"{split.scheme}://{split.netloc}"
        self.path = (split.path or "/") + \
            (f"?{split.query}" if split.query else "")


def parse_target(spec: str) -> Target:
    """``JOB=URL`` -> Target (the --targets flag grammar)."""
    job, sep, url = spec.partition("=")
    if not sep or not job or not url:
        raise ValueError(f"target {spec!r} is not JOB=URL")
    return Target(job, url)


class ScrapeManager:
    """Polls every target each ``interval_s`` from one daemon thread,
    ingesting parsed samples (labeled ``job=``) into ``tsdb``.

    FAIL-OPEN, hard: a scrape is one wall-bounded wire attempt
    (``timeout_s``, the whole-attempt discipline via
    ``Client.get_raw``); a refused/stalled/garbled target marks
    ``up{job} 0`` and the loop proceeds — no exception ever leaves a
    scrape, pinned by the 100%-targets-down test. Self-metrics per
    scrape: ``up``, ``tpuctl_scrape_duration_seconds`` and
    ``tpuctl_scrape_samples_total`` land in the TSDB (and mirror into
    ``telemetry`` when attached).
    """

    def __init__(self, targets: Sequence[Target], tsdb: TSDB,
                 interval_s: float = 1.0, timeout_s: float = 2.0,
                 telemetry: Optional[_telemetry.Telemetry] = None) -> None:
        jobs = [t.job for t in targets]
        if len(set(jobs)) != len(jobs):
            raise ValueError(f"duplicate scrape job names: {jobs}")
        # immutable after construction (mutated only before the scrape
        # thread can see them)
        self.targets = list(targets)  # thread-owned
        self.tsdb = tsdb
        self.interval_s = max(0.01, float(interval_s))
        self.timeout_s = max(0.05, float(timeout_s))
        self.telemetry = telemetry
        # one keep-alive client per target, each attempt wall-bounded;
        # NO_RETRY: the next tick IS the retry, and a dead target must
        # cost one attempt per tick, not a backoff ladder. Map frozen
        # after construction; each Client guards its own internals.
        self._clients: Dict[str, kubeapply.Client] = {  # thread-owned
            t.job: kubeapply.Client(
                t.base_url, timeout=self.timeout_s,
                attempt_deadline_s=self.timeout_s,
                retry=kubeapply.NO_RETRY)
            for t in self.targets}
        self._lock: Any = threading.Lock()
        self._scrapes = 0  # guarded-by: _lock
        # per-job cumulative ingested-sample counts (the
        # tpuctl_scrape_samples_total synthesis reads monotonic totals)
        self._samples_total: Dict[str, int] = {}  # guarded-by: _lock
        self._last_up: Dict[str, bool] = {}  # guarded-by: _lock
        # per-job timestamp of the previous SUCCESSFUL scrape (TSDB
        # clock) — the zero-baseline anchor for counter series born
        # between two scrapes of an observed target
        self._last_ok_ts: Dict[str, float] = {}  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- surface

    def start(self) -> "ScrapeManager":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            daemon=True,
                                            name="scrape-manager")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for client in self._clients.values():
            client.close()

    def __enter__(self) -> "ScrapeManager":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    def healthy(self) -> bool:
        """Is the scrape loop itself alive? (Target health is data —
        read ``up`` off the TSDB; THIS answers 'did the thread die',
        which the fail-open contract says must never happen.)"""
        return self._thread is not None and self._thread.is_alive()

    def scrapes(self) -> int:
        with self._lock:
            return self._scrapes

    def up_snapshot(self) -> Dict[str, bool]:
        """{job: last scrape succeeded} — the CLI's down-target note."""
        with self._lock:
            return dict(self._last_up)

    def scrape_once(self) -> Dict[str, bool]:
        """One pass over every target (the deterministic test/CLI
        surface; the loop thread calls exactly this). Never raises."""
        results: Dict[str, bool] = {}
        for target in self.targets:
            try:
                results[target.job] = self._scrape_target(target)
            except Exception:  # noqa: BLE001 — fail-open is the contract
                results[target.job] = False
                self._record(target.job, False, 0, self.timeout_s)
        with self._lock:
            self._scrapes += 1
        return results

    # ---------------------------------------------------------- internals

    def _scrape_target(self, target: Target) -> bool:
        client = self._clients[target.job]
        t0 = time.monotonic()
        code, payload = client.get_raw(target.path)
        duration = time.monotonic() - t0
        up = False
        count = 0
        if code == 200:
            try:
                scrape = parse_text(
                    payload.decode("utf-8", errors="replace"))
            except ValueError:
                up = False  # garbled exposition = dead target
            else:
                with self._lock:
                    baseline = self._last_ok_ts.get(target.job)
                ingest_ts = self.tsdb.now()
                count = self.tsdb.ingest(scrape,
                                         labels={"job": target.job},
                                         ts=ingest_ts,
                                         zero_baseline_ts=baseline)
                with self._lock:
                    self._last_ok_ts[target.job] = ingest_ts
                up = True
        self._record(target.job, up, count, duration)
        return up

    def _record(self, job: str, up: bool, count: int,
                duration: float) -> None:
        """Accounting + self-metric synthesis for one finished scrape.
        The decision state lives under ``_lock``; every TSDB/telemetry
        write happens OUTSIDE it (leaf-only)."""
        with self._lock:
            total = self._samples_total.get(job, 0) + count
            self._samples_total[job] = total
            self._last_up[job] = up
        job_labels = {"job": job}
        self.tsdb.append(_telemetry.UP, job_labels,
                         1.0 if up else 0.0, mtype="gauge")
        self.tsdb.append(_telemetry.SCRAPE_DURATION_SECONDS, job_labels,
                         duration, mtype="gauge")
        self.tsdb.append(_telemetry.SCRAPE_SAMPLES_TOTAL, job_labels,
                         float(total), mtype="counter")
        tel = self.telemetry
        if tel is not None:
            try:
                tel.gauge(_telemetry.UP,
                          "1 = the target's last scrape parsed, "
                          "0 = dead",
                          job=job).set(1.0 if up else 0.0)
                tel.histogram(_telemetry.SCRAPE_DURATION_SECONDS,
                              "wall seconds per scrape attempt",
                              job=job).observe(duration)
                if count:
                    tel.counter(_telemetry.SCRAPE_SAMPLES_TOTAL,
                                "exposition samples ingested into the "
                                "TSDB", job=job).inc(count)
            except Exception:  # noqa: BLE001 — fail-open: a registry
                # type collision on a self-metric name (caller already
                # owns e.g. an `up` counter) must not kill the scrape
                # thread; the TSDB synthesis above already landed
                pass

    def _run(self) -> None:
        while not self._stop.is_set():
            self.scrape_once()
            self._stop.wait(self.interval_s)




# --------------------------------------------------------------------------
# Serving: a registry behind a daemon-threaded /metrics endpoint.


class MetricsServer:
    """Expose one ``MetricsRegistry`` over HTTP (``/metrics``,
    exposition content type) from a daemon thread — what makes a
    serving replica a scrape target. Construction BINDS: a port conflict
    raises OSError immediately so the caller can apply its own policy."""

    def __init__(self, registry: _telemetry.MetricsRegistry, port: int,
                 host: str = "127.0.0.1") -> None:
        self.registry = registry
        # Live handler connections, severed by stop(): shutdown() only
        # stops the LISTENER — an established keep-alive handler thread
        # would keep serving the registry to a connected scraper after
        # "stop". Leaf lock, never nested.
        self._conns: List[Any] = []  # guarded-by: _conns_lock
        self._conns_lock: Any = threading.Lock()

        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self) -> None:
                super().setup()
                with server_ref._conns_lock:
                    server_ref._conns.append(self.connection)

            def finish(self) -> None:
                try:
                    super().finish()
                finally:
                    with server_ref._conns_lock:
                        try:
                            server_ref._conns.remove(self.connection)
                        except ValueError:
                            pass

            def log_message(self, *args: Any) -> None:
                pass

            def do_GET(self) -> None:
                if self.path.partition("?")[0] != "/metrics":
                    body = b"try /metrics\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                body = server_ref.registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"metrics-server-{self.port}")

    @property
    def port(self) -> int:
        return int(self._server.server_address[1])

    @property
    def url(self) -> str:
        host = str(self._server.server_address[0])
        return f"http://{host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        # sever established keep-alive handlers: a scraper's parked
        # connection must die with the server, not keep being answered
        # by a zombie handler thread (see _conns)
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._server.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()


# --------------------------------------------------------------------------
# Live SLO: SLODef burn-rate rules over scraped counter ratios.

# Request-counter families carrying a per-sample status ``code`` label,
# in preference order: the client's own registry when scraped, else the
# fake apiserver's audit. Good/bad classification is slo._is_bad_status
# — the SAME taxonomy the span extractor applies, which is what makes
# the live and trace-derived verdicts comparable at all.
_LIVE_CODE_FAMILIES: Dict[str, Tuple[str, ...]] = {
    "apply-availability": (_telemetry.REQUESTS_TOTAL,
                           "fake_apiserver_requests_total"),
}


def _code_ratio_source(tsdb: TSDB, families: Sequence[str],
                       now: Optional[float]) -> _slo.SampleSource:
    # the evidence family is chosen ONCE per source, not per window:
    # falling back per ratio() call could answer one verdict's short
    # window from the server's counters and its long window from the
    # client's — two vantages with different traffic mixes, AND-gated
    # into a verdict neither consistent choice would produce
    family = next((f for f in families if tsdb.has_series(f)), None)

    def ratio(window_s: float) -> Tuple[float, float]:
        if family is None:
            return 0.0, 0.0
        increases = tsdb.increase(family, window_s, now=now)
        total = sum(increases.values())
        if total <= 0:
            return 0.0, 0.0
        bad = sum(v for pairs, v in increases.items()
                  if _slo._is_bad_status(dict(pairs).get("code")))
        return bad, total
    return ratio


def live_slo_report(tsdb: TSDB,
                    slos: Sequence[_slo.SLODef] = _slo.DEFAULT_SLOS,
                    windows: Sequence[_slo.BurnWindow] =
                    _slo.DEFAULT_WINDOWS,
                    scale: Optional[float] = None,
                    now: Optional[float] = None) -> _slo.SLOReport:
    """The ``slo check --live`` evaluator: each SLO's burn-rate
    rules over windowed bad/total ratios of the scraped code-labeled
    request counters (``slo.evaluate_sources`` — the same verdict
    math, report shape and rc contract as the span path). SLOs with no
    live counter expression (watch-uptime, admission-latency) evaluate
    with zero samples — 'ok (no samples)' in the report, visibly. The
    default ``scale`` anchors the 1h page window onto the TSDB's
    observed scrape span, exactly like the trace path anchors onto the
    trace span."""
    sources: Dict[str, _slo.SampleSource] = {}
    for slo_def in slos:
        families = _LIVE_CODE_FAMILIES.get(slo_def.name)
        if families:
            sources[slo_def.name] = _code_ratio_source(tsdb, families,
                                                       now)
    return _slo.evaluate_sources(sources, slos=slos, windows=windows,
                                 scale=scale, span_s=tsdb.span_s())


# --------------------------------------------------------------------------
# Dashboard.

_SPARK_LEVELS = "▁▂▃▄▅▆▇█"
_DASH_SLOTS = 12


def sparkline(values: Sequence[float]) -> str:
    """Values -> one block character each, scaled to the series max
    (an all-zero series is a flat floor — 'quiet', not 'missing')."""
    if not values:
        return ""
    top = max(values)
    if top <= 0:
        return _SPARK_LEVELS[0] * len(values)
    out: List[str] = []
    for v in values:
        idx = int((max(0.0, v) / top) * (len(_SPARK_LEVELS) - 1) + 0.5)
        out.append(_SPARK_LEVELS[idx])
    return "".join(out)


def _slot_rates(tsdb: TSDB, family: str, job: str, window_s: float,
                now: float) -> List[float]:
    """Per-slot summed request rate over the window, oldest slot
    first (the sparkline's input). ONE store fetch covers all 12
    slots — the per-slot math (bounded window, capped baseline
    lookback, reset-aware increase over the observed span) is the same
    as :meth:`TSDB.rate`, computed locally on the single snapshot
    instead of re-scanning the store per slot."""
    slot = window_s / _DASH_SLOTS
    fetch = tsdb.window(family, window_s + slot + tsdb.staleness_s,
                        now=now, job=job)
    out: List[float] = []
    for i in range(_DASH_SLOTS):
        slot_now = now - (_DASH_SLOTS - 1 - i) * slot
        total = 0.0
        for samples in fetch.values():
            value = TSDB._slice_rate(TSDB._window_slice(
                samples, slot_now - slot, slot_now, tsdb.staleness_s))
            if value is not None:
                total += value
        out.append(total)
    return out


# Request-counter families a dash row tries in order (same preference
# as the live SLO mapping).
_DASH_REQUEST_FAMILIES = (_telemetry.REQUESTS_TOTAL,
                          "fake_apiserver_requests_total")
# Event-count families summed for the footer.
_DASH_EVENT_FAMILIES = (_telemetry.EVENTS_EMITTED_TOTAL,
                        "fake_apiserver_events_total")


def render_dash(tsdb: TSDB, window_s: float = 60.0,
                now: Optional[float] = None) -> str:
    """One terminal frame over the TSDB: a row per scrape job (``up``,
    summed request/error rates over the window, p99 request latency,
    request-rate sparkline across the window's 12 slots) plus an event
    footer. Deterministic for a fixed (tsdb, now) pair — the golden
    replay pin renders from a dumped TSDB with a frozen clock."""
    t = tsdb.now() if now is None else now
    jobs = tsdb.label_values(_telemetry.UP, "job")
    lines: List[str] = [
        f"tpuctl dash — {len(jobs)} target(s), window {window_s:g}s",
        f"{'JOB':<14} {'UP':>2} {'REQ/S':>8} {'ERR/S':>8} "
        f"{'P99(MS)':>8}  {'REQUESTS ' + '·' * (_DASH_SLOTS - 9)}",
    ]
    for job in jobs:
        up_vals = tsdb.latest(_telemetry.UP, now=t, job=job)
        up = "1" if aggregate(up_vals, "max") > 0 else \
            ("0" if up_vals else "?")
        family = ""
        rates: Dict[LabelPairs, float] = {}
        for cand in _DASH_REQUEST_FAMILIES:
            cand_rates = tsdb.rate(cand, window_s, now=t, job=job)
            if cand_rates:
                family, rates = cand, cand_rates
                break
        req = err = 0.0
        spark = _SPARK_LEVELS[0] * _DASH_SLOTS
        if family:
            req = aggregate(rates, "sum")
            err = aggregate(
                {p: v for p, v in rates.items()
                 if _slo._is_bad_status(dict(p).get("code"))}, "sum")
            spark = sparkline(
                _slot_rates(tsdb, family, job, window_s, t))
        p99 = tsdb.histogram_quantile(
            0.99, _telemetry.REQUEST_SECONDS, window_s=window_s,
            now=t, job=job)
        p99_text = f"{p99 * 1e3:8.1f}" if p99 is not None \
            else f"{'-':>8}"
        lines.append(f"{job:<14} {up:>2} {req:8.1f} {err:8.1f} "
                     f"{p99_text}  {spark}")
    # serving panel: fleet-wide decoded-token rate (sparkline summed
    # across replicas), live queue depth, and the autoscaler's desired
    # replica count — present only once the serving path has series
    # (a batch-only cluster keeps the classic frame).
    serving_jobs = tsdb.label_values(_telemetry.SERVING_TOKENS_TOTAL,
                                     "job")
    if serving_jobs or tsdb.has_series(_telemetry.AUTOSCALE_REPLICAS):
        slots = [0.0] * _DASH_SLOTS
        for job in serving_jobs:
            for i, v in enumerate(_slot_rates(
                    tsdb, _telemetry.SERVING_TOKENS_TOTAL, job,
                    window_s, t)):
                slots[i] += v
        tok = aggregate(tsdb.rate(_telemetry.SERVING_TOKENS_TOTAL,
                                  window_s, now=t), "sum")
        queue = aggregate(tsdb.latest(_telemetry.SERVING_QUEUE_DEPTH,
                                      now=t), "sum")
        reps = tsdb.latest(_telemetry.AUTOSCALE_REPLICAS, now=t)
        reps_text = str(int(round(aggregate(reps, "max")))) \
            if reps else "-"
        lines.append(f"serving ({window_s:g}s): tok/s {tok:.1f} "
                     f"{sparkline(slots)} | queue {queue:g} | "
                     f"replicas {reps_text}")
    by_reason: Dict[str, float] = {}
    for family in _DASH_EVENT_FAMILIES:
        for pairs, inc in tsdb.increase(family, window_s,
                                        now=t).items():
            reason = dict(pairs).get("reason", "?")
            if inc > 0:
                by_reason[reason] = by_reason.get(reason, 0.0) + inc
    if by_reason:
        rendered = ", ".join(f"{reason} {int(round(count))}"
                             for reason, count in
                             sorted(by_reason.items()))
        lines.append(f"events ({window_s:g}s): {rendered}")
    else:
        lines.append(f"events ({window_s:g}s): (none)")
    return "\n".join(lines)
