"""Unified telemetry: hierarchical spans + a Prometheus-text metrics
registry, dependency-free (stdlib only). The port's own copy of
``tpu_cluster/telemetry.py``: the metrics half, the tracer half and the
flight recorder.

Two halves, one facade (:class:`Telemetry`):

TRACING -- :class:`Tracer` builds a tree of :class:`Span` objects
(rollout -> group -> tier -> object -> HTTP attempt). Parent linkage is a
per-thread span stack, with an explicit ``parent=`` override at thread
boundaries (the pipelined engine's worker pool, the per-collection watch
threads). Spans carry ``args`` (annotations: status codes, apply actions)
and instant *events* (retry/backoff/chaos marks). The whole tree exports
as Chrome trace-event format (``chrome_trace()``): one ``ph: "X"``
complete event per span, one ``ph: "i"`` instant event per span event,
loadable in ``chrome://tracing`` / Perfetto.

METRICS -- :class:`MetricsRegistry` holds counter / gauge / histogram
families keyed by name, each with labeled children created on demand.
Histograms use FIXED buckets (cumulative ``le`` encoding, ``+Inf``
implicit) so two processes observing the same distribution render
byte-comparable bucket lines. ``render()`` emits Prometheus text
exposition format.

TRACE CORRELATION -- every :class:`Tracer` owns a W3C trace id and every
span a span id; ``kubeapply.Client`` sends a ``traceparent`` header per
wire attempt (the attempt's leaf span is the parent context), and
:class:`FlightRecorder` keeps a bounded always-on ring of the last
spans/retry events, atomically flushed so a SIGKILL'd rollout still
leaves a post-mortem trace even when ``--trace-out`` wasn't passed.

Names read by other processes keep the reference's spelling: the
``tpuctl_*`` client families, the ``tpu_serving_*`` families the
autoscaler reads, :data:`OPERATOR_METRIC_NAMES` (the native operator's
``/metrics`` contract), :data:`OPERATOR_TRACE_EVENTS` (the slice names
its trace emitter writes) and :data:`TRACEPARENT_ANNOTATION`. The trace
readers close the module: :func:`summarize_trace` (``top``),
:func:`validate_chrome_trace` and :func:`merge_traces` (``trace``).

Every lock in this module is leaf-only: nothing is acquired while one
is held.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

# --------------------------------------------------------------------------
# Pinned metric names.

# Families the C++ operator's /metrics endpoint must emit
# (kubeapi::OperatorMetricNames(), native/operator/kubeapi.cc; `verify
# --config operator-metrics` fails a live scrape that lacks one).
# Conditional families (e.g. the
# --leader-elect-only tpu_operator_leader gauge) are deliberately NOT
# here: the live-scrape check must hold on every configuration.
OPERATOR_METRIC_NAMES: Tuple[str, ...] = (
    "tpu_operator_objects",
    "tpu_operator_passes_total",
    "tpu_operator_healthy",
    "tpu_operator_consecutive_failures",
    "tpu_operator_policy_generation",
    "tpu_operator_reconcile_duration_seconds",
    "tpu_operator_watch_reconnects_total",
    "tpu_operator_queue_depth",
    "tpu_operator_sync_lag_seconds",
    "tpu_operator_workqueue_adds_total",
    "tpu_operator_workqueue_retries_total",
    "tpu_operator_workqueue_depth",
)

# Chrome trace-event slice names the C++ operator's trace emitter must
# use (kubeapi::OperatorTraceEventNames(), native/operator/kubeapi.cc) —
# pinned the same three ways as OPERATOR_METRIC_NAMES: selftest.cc pins
# the C++ table compiler-only, tests/test_telemetry.py source-greps the
# equality, and CI greps the operator's emitted trace artifact for them.
# A rename lands on these pins before it lands on a broken merged
# timeline.
OPERATOR_TRACE_EVENTS: Tuple[str, ...] = (
    "reconcile-pass",   # one full ReconcilePass (apply + gates + status)
    "apply-object",     # one bundle object through ApplyObject
    "ready-wait",       # one stage's readiness gate
    "watch-sleep",      # one event-driven sleep holding watch streams
    "drift-event",      # instant: a watch event that triggers reconcile
    "reconcile-object", # one workqueue key through Reconcile(key)
)

# Span names of the serving engine (workloads/serving.py), in the order
# one decoding step opens them; a step that seats no slot opens the first
# three alone, and run() then waits for work in ``serving.park``, a root
# of its own. Sites and the readers of a traced run take the names from
# here.
SERVING_SPANS: Tuple[str, ...] = (
    "serving.iteration",  # root: one step(); args seated (0: no decode),
                          # admitted, evicted
    "serving.admit",      # deadline drops and prompt writes
    "serving.gauges",     # the engine's gauges
    "serving.upload",     # the rows to project (the K/V cache's host
                          # mirror), host->device copy of their tokens
                          # and positions
    "serving.dispatch",   # inference mode, projections, cache writes,
                          # attention, tail, argmax: launched, not run;
                          # args tail_rows, projected_rows, cached_rows
    "serving.sync",       # the copy back, which waits for the device
    "serving.emit",       # duty samples, token append, evictions, counters
    "serving.park",       # root: the wait for work with no slot seated
)

# Span names of one training step (workloads/burnin.py): the root, then
# its two children.
TRAIN_SPANS: Tuple[str, ...] = (
    "train.step",
    "train.loss_and_grads",
    "train.sgd_update",
)

# Span names of a routed expert layer (workloads/sparse.py), in the order
# its forward opens them inside ``train.loss_and_grads``; its backward
# opens them again, from autograd's thread, with ``phase="bwd"``.
MOE_SPANS: Tuple[str, ...] = (
    "moe.route",     # router product, softmax, top-k and renormalisation
    "moe.dispatch",  # routed pairs sorted by expert, rows gathered
    "moe.experts",   # the grouped SwiGLU products over each expert's rows
    "moe.combine",   # expert outputs weighted and summed back per token
)

# The Python client/rollout family names (one place so instrumentation
# sites and assertions cannot drift on spelling).
REQUESTS_TOTAL = "tpuctl_requests_total"
REQUEST_SECONDS = "tpuctl_request_duration_seconds"
RETRIES_TOTAL = "tpuctl_retries_total"
HEDGES_TOTAL = "tpuctl_hedges_total"
UNCHANGED_TOTAL = "tpuctl_apply_unchanged_total"
READY_SECONDS = "tpuctl_ready_seconds"
WATCH_RECONNECTS_TOTAL = "tpuctl_watch_reconnects_total"
JOURNAL_SKIPS_TOTAL = "tpuctl_journal_skips_total"
VERIFY_KUBECTL_CALLS = "tpuctl_verify_kubectl_calls_total"
# Gang admission: the admission loop's control-plane families.
ADMISSIONS_TOTAL = "tpuctl_admissions_total"
PREEMPTIONS_TOTAL = "tpuctl_preemptions_total"
GANG_WAIT_SECONDS = "tpuctl_gang_wait_seconds"
# Fleet-scale control plane: paginated-LIST and informer
# families. LIST_PAGES counts every page of a limit/continue chase (the
# 1000-node re-sync audit); the informer families are the watch-cache's
# vitals — events applied, full re-LISTs (initial sync / 410 resume;
# an idle fleet holds this at its post-sync value, the zero-LIST pin),
# and the lag from event receipt to cache-applied-and-notified.
LIST_PAGES_TOTAL = "tpuctl_list_pages_total"
INFORMER_EVENTS_TOTAL = "tpuctl_informer_events_total"
INFORMER_RELISTS_TOTAL = "tpuctl_informer_relists_total"
INFORMER_LAG_SECONDS = "tpuctl_informer_lag_seconds"
# Kubernetes Events pipeline: the recorder's own vitals.
# EMITTED counts every emit() that reached the wire (new Event POSTs and
# aggregated count-bump PATCHes alike, labeled by reason); DROPPED
# counts emits the token-bucket spam filter refused before any request;
# EMIT_FAILURES is the fail-open contract's only failure surface — a
# refused/failed Event write bumps it and NOTHING else happens (no
# retry, no raised error, the hot path proceeds).
EVENTS_EMITTED_TOTAL = "tpuctl_events_emitted_total"
EVENTS_DROPPED_TOTAL = "tpuctl_events_dropped_total"
EVENT_EMIT_FAILURES_TOTAL = "tpuctl_event_emit_failures_total"
# Continuous metrics: the scrape pipeline's self-metrics. UP is the
# Prometheus liveness convention -- 1 for a target whose scrape parsed,
# 0 for a dead or garbled one -- synthesized per target by
# metricsdb.ScrapeManager next to its own duration and ingested-sample
# vitals.
UP = "up"
SCRAPE_DURATION_SECONDS = "tpuctl_scrape_duration_seconds"
SCRAPE_SAMPLES_TOTAL = "tpuctl_scrape_samples_total"
# Rolling maintenance: the MaintenanceController's families.
# TRANSITIONS counts every wave-group phase transition (labeled by the
# phase entered: cordoned/drained/upgraded/done); WAVES counts completed
# wave plans; DRAINING_GANGS and CORDONED_HOSTS are the live disruption
# gauges the budget bounds; GROUP_SECONDS is the cordon->done wall per
# host group.
MAINTENANCE_TRANSITIONS_TOTAL = "tpu_maintenance_transitions_total"
MAINTENANCE_WAVES_TOTAL = "tpu_maintenance_waves_total"
MAINTENANCE_DRAINING_GANGS = "tpu_maintenance_draining_gangs"
MAINTENANCE_CORDONED_HOSTS = "tpu_maintenance_cordoned_hosts"
MAINTENANCE_GROUP_SECONDS = "tpu_maintenance_group_seconds"
# Continuous-batching serving: the inference operand's families, per
# replica on its MetricsServer scrape. QUEUE_DEPTH is the admission queue
# the autoscaler watches; BATCH_SLOTS / BATCH_OCCUPANCY are the decode
# batch's configured vs currently-seated slots; TOKENS_TOTAL counts
# decoded tokens (tokens/s via rate()); REQUESTS_TOTAL is code-labeled;
# PHASE_SECONDS is the per-phase latency histogram (queue|prefill|decode)
# and REQUEST_SECONDS the end-to-end wall; EVICTIONS counts mid-batch slot
# evictions labeled by cause (done|deadline).
SERVING_QUEUE_DEPTH = "tpu_serving_queue_depth"
SERVING_BATCH_SLOTS = "tpu_serving_batch_slots"
SERVING_BATCH_OCCUPANCY = "tpu_serving_batch_occupancy"
SERVING_TOKENS_TOTAL = "tpu_serving_tokens_total"
SERVING_REQUESTS_TOTAL = "tpu_serving_requests_total"
SERVING_PHASE_SECONDS = "tpu_serving_phase_seconds"
SERVING_REQUEST_SECONDS = "tpu_serving_request_seconds"
SERVING_EVICTIONS_TOTAL = "tpu_serving_evictions_total"
# Metrics-driven autoscaling: the HPA-analog controller's families.
# REPLICAS is the desired replica count it converges the serving Jobs
# to; DECISIONS counts every pass's verdict (labeled up|down|hold|
# blocked); REACTION_SECONDS is the overload-observed to scale-decision
# wall.
AUTOSCALE_REPLICAS = "tpu_autoscale_replicas"
AUTOSCALE_DECISIONS_TOTAL = "tpu_autoscale_decisions_total"
AUTOSCALE_REACTION_SECONDS = "tpu_autoscale_reaction_seconds"

# Fixed default buckets, request-latency shaped (seconds). Shared with
# the ready-wait histogram: its tail rides the +Inf bucket.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)

# The annotation the CLI stamps on objects it MUTATES (never on a no-op
# skip) when telemetry is armed, carrying the apply's traceparent so the
# operator can attribute its reconcile slices to the rollout that caused
# them. Twin of kubeapi::TraceparentAnnotation() (native/operator/
# kubeapi.cc), pinned by selftest.cc + a source-grep in tests.
TRACEPARENT_ANNOTATION = "tpu-stack.dev/traceparent"

LabelPairs = Tuple[Tuple[str, str], ...]


# --------------------------------------------------------------------------
# W3C Trace Context (traceparent) helpers.
#
# The wire format is `00-<32 hex trace-id>-<16 hex parent-id>-<2 hex
# flags>` (https://www.w3.org/TR/trace-context/). One Tracer = one trace
# id; every wire attempt gets its own span id, sent as the parent-id so
# the server's span nests under the exact attempt that caused it.

def new_trace_id() -> str:
    """128-bit random trace id, 32 lowercase hex chars (never all-zero —
    the spec reserves it as invalid)."""
    return f"{random.getrandbits(128) or 1:032x}"


def new_span_id() -> str:
    """64-bit random span id, 16 lowercase hex chars (never all-zero)."""
    return f"{random.getrandbits(64) or 1:016x}"


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


_HEX_DIGITS = frozenset("0123456789abcdefABCDEF")


def _hex_field(value: str, width: int) -> bool:
    """Exactly ``width`` hex digits, not all zero — a STRICT check
    (int(x, 16) would tolerate '0x' prefixes, signs and whitespace,
    which the pinned C++ twin kubeapi::ParseTraceparent rejects; the
    three parsers must agree byte-for-byte on what correlates)."""
    return (len(value) == width and set(value) <= _HEX_DIGITS
            and set(value) != {"0"})


def parse_traceparent(header: str) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_id)`` from a traceparent header, or None for
    anything malformed (a server must tolerate garbage headers)."""
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    _version, trace_id, parent_id, _flags = parts
    if not _hex_field(trace_id, 32) or not _hex_field(parent_id, 16):
        return None
    return trace_id, parent_id



def _label_pairs(labels: Dict[str, str]) -> LabelPairs:
    return tuple(sorted(labels.items()))


def escape_label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline) —
    the WRITE half of the exposition format's label grammar."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def unescape_label(value: str) -> str:
    """Inverse of :func:`escape_label`: one left-to-right pass decoding
    ``\\\\``, ``\\"`` and ``\\n`` (an unknown escape keeps its backslash
    verbatim, the Prometheus parser's tolerance rule). Sequential on
    purpose — chained str.replace would mis-decode ``\\\\n`` (an escaped
    backslash followed by a literal n) into a newline."""
    out: List[str] = []
    i = 0
    n = len(value)
    while i < n:
        c = value[i]
        if c == "\\" and i + 1 < n:
            nxt = value[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == '"':
                out.append('"')
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)



def _fmt(value: float) -> str:
    """Render a sample value: integers without a trailing .0, other
    floats rounded to 9 decimals."""
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(round(value, 9))


def fmt_value(value: float) -> str:
    """Public face of :func:`_fmt` — the scrape-side parity surface:
    :meth:`MetricsRegistry.samples` spells histogram ``le`` labels with
    it, and the metricsdb parser's round-trip check compares against
    those exact strings."""
    return _fmt(value)


class Counter:
    """Monotonic counter (one labeled child of a family)."""

    def __init__(self) -> None:
        self._lock: Any = threading.Lock()
        self._value = 0.0  # guarded-by: _lock

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Set-to-current-value gauge (one labeled child of a family)."""

    def __init__(self) -> None:
        self._lock: Any = threading.Lock()
        self._value = 0.0  # guarded-by: _lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram. ``counts[i]`` is the NON-cumulative count
    for bucket i (rendering emits the cumulative ``le`` encoding, with
    ``+Inf`` as the implicit last bucket)."""

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        if list(buckets) != sorted(buckets) or len(set(buckets)) != \
                len(buckets):
            raise ValueError(f"buckets must be strictly increasing: "
                             f"{buckets}")
        self.buckets = tuple(float(b) for b in buckets)
        self._lock: Any = threading.Lock()
        # +1 = the +Inf bucket
        self.counts = [0] * (len(self.buckets) + 1)  # guarded-by: _lock
        self.sum = 0.0  # guarded-by: _lock
        self.count = 0  # guarded-by: _lock

    def observe(self, v: float) -> None:
        idx = len(self.buckets)  # +Inf unless a bound catches it
        for i, bound in enumerate(self.buckets):
            if v <= bound:
                idx = i
                break
        with self._lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1

    def cumulative(self) -> List[int]:
        """Cumulative per-bucket counts, ``le`` encoding (last == count)."""
        return self.snapshot()[0]

    def snapshot(self) -> Tuple[List[int], float]:
        """(cumulative bucket counts, sum) read under ONE lock hold, so
        a concurrent observe() cannot skew the rendered sum against the
        rendered count (``cumulative[-1]`` IS the observation count)."""
        out: List[int] = []
        total = 0
        with self._lock:
            for c in self.counts:
                total += c
                out.append(total)
            return out, self.sum


class _Family:
    def __init__(self, name: str, mtype: str, help_text: str,
                 buckets: Tuple[float, ...]) -> None:
        self.name = name
        self.mtype = mtype
        self.help = help_text
        self.buckets = buckets
        # labeled children, created on demand under the OWNING
        # registry's lock (a _Family never leaves its registry)
        self.series: Dict[LabelPairs, Any] = {}


class MetricsRegistry:
    """Counter/gauge/histogram families, rendered as Prometheus text."""

    def __init__(self) -> None:
        self._lock: Any = threading.Lock()
        self._families: Dict[str, _Family] = {}  # guarded-by: _lock

    def _child(self, name: str, mtype: str, help_text: str,
               labels: Dict[str, str],
               buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Any:
        key = _label_pairs(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, mtype, help_text, buckets)
                self._families[name] = fam
            elif fam.mtype != mtype:
                raise ValueError(
                    f"metric {name} is a {fam.mtype}, not a {mtype}")
            elif mtype == "histogram" and tuple(buckets) != fam.buckets:
                # as loud as the type-mismatch above: silently dropping a
                # caller's buckets would pile its observations into the
                # wrong distribution (one bucket layout per family)
                raise ValueError(
                    f"histogram {name} already registered with buckets "
                    f"{fam.buckets}, not {tuple(buckets)}")
            child = fam.series.get(key)
            if child is None:
                if mtype == "counter":
                    child = Counter()
                elif mtype == "gauge":
                    child = Gauge()
                else:
                    child = Histogram(fam.buckets)
                fam.series[key] = child
            return child

    def counter(self, name: str, help_text: str = "",
                **labels: str) -> Counter:
        child = self._child(name, "counter", help_text, labels)
        assert isinstance(child, Counter)
        return child

    def gauge(self, name: str, help_text: str = "",
              **labels: str) -> Gauge:
        child = self._child(name, "gauge", help_text, labels)
        assert isinstance(child, Gauge)
        return child

    def histogram(self, name: str, help_text: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        child = self._child(name, "histogram", help_text, labels,
                            buckets=buckets)
        assert isinstance(child, Histogram)
        return child

    def total(self, name: str, **label_filter: str) -> float:
        """Sum of a family's children values (counters/gauges; histograms
        contribute their observation COUNT), restricted to children whose
        labels include every ``label_filter`` pair. 0.0 for an absent
        family — assertions read totals without creating families."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return 0.0
            children = list(fam.series.items())
        want = set(label_filter.items())
        out = 0.0
        for key, child in children:
            if not want <= set(key):
                continue
            if isinstance(child, Histogram):
                # observation count under the histogram's own lock —
                # totals race with concurrent observe() otherwise
                with child._lock:
                    out += child.count
            else:
                out += float(child.value)
        return out

    def render(self) -> str:
        """Prometheus text exposition format, families and children in
        sorted order (byte-stable across runs with equal contents)."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.mtype}")
            with self._lock:
                # the series dict grows under the registry lock; copy
                # under it so a concurrent labeled-child creation cannot
                # mutate the dict mid-iteration
                series = sorted(fam.series.items())
            for key, child in series:
                label_text = ",".join(
                    f'{k}="{escape_label(v)}"' for k, v in key)
                if isinstance(child, Histogram):
                    # one consistent snapshot per histogram: cumulative
                    # buckets, sum and count must agree with each other
                    # even while another thread observes
                    cum, h_sum = child.snapshot()
                    h_count = cum[-1]  # +Inf cumulative == total count
                    for bound, c in zip(child.buckets, cum):
                        b_labels = ",".join(filter(None, [
                            label_text, f'le="{_fmt(bound)}"']))
                        lines.append(
                            f"{name}_bucket{{{b_labels}}} {c}")
                    inf_labels = ",".join(filter(None,
                                                 [label_text, 'le="+Inf"']))
                    lines.append(f"{name}_bucket{{{inf_labels}}} "
                                 f"{h_count}")
                    suffix = f"{{{label_text}}}" if label_text else ""
                    lines.append(f"{name}_sum{suffix} {_fmt(h_sum)}")
                    lines.append(f"{name}_count{suffix} {h_count}")
                else:
                    suffix = f"{{{label_text}}}" if label_text else ""
                    lines.append(f"{name}{suffix} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def samples(self) -> Dict[Tuple[str, LabelPairs], float]:
        """Every sample line :meth:`render` emits, as a flat ``{(name,
        sorted label pairs): value}`` mapping — histograms expand to
        their cumulative ``_bucket`` rows (``le`` spelled via
        :func:`fmt_value`, ``+Inf`` included), ``_sum`` and ``_count``,
        exactly as rendered. This is the render/parse symmetry surface:
        ``metricsdb.parse_text(reg.render()).samples == reg.samples()``."""
        out: Dict[Tuple[str, LabelPairs], float] = {}
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            with self._lock:
                series = sorted(fam.series.items())
            for key, child in series:
                if isinstance(child, Histogram):
                    cum, h_sum = child.snapshot()
                    for bound, c in zip(child.buckets, cum):
                        le_key = tuple(sorted(
                            key + (("le", fmt_value(bound)),)))
                        out[(f"{name}_bucket", le_key)] = float(c)
                    inf_key = tuple(sorted(key + (("le", "+Inf"),)))
                    out[(f"{name}_bucket", inf_key)] = float(cum[-1])
                    # values pass through the SAME _fmt spelling render
                    # prints (repr(round(v, 9)) for fractions): a raw
                    # 0.1+0.2 sum would compare 0.30000000000000004
                    # against the parsed 0.3
                    out[(f"{name}_sum", key)] = float(fmt_value(h_sum))
                    out[(f"{name}_count", key)] = float(cum[-1])
                else:
                    out[(name, key)] = float(fmt_value(child.value))
        return out

    def family_types(self) -> Dict[str, str]:
        """{family name: counter|gauge|histogram} — the ``# TYPE`` lines
        render() emits, for the parser parity pin."""
        with self._lock:
            return {name: fam.mtype for name, fam in self._families.items()}


# --------------------------------------------------------------------------
# Tracing.


class Span:
    """One timed node of the trace tree. Created via :meth:`Tracer.span`
    (context-managed) or :meth:`Tracer.leaf` (already-completed wire
    attempts); ``annotate`` adds args, ``event`` adds an instant mark
    (retry/backoff/chaos annotations ride here)."""

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 parent: Optional["Span"],
                 args: Dict[str, Any],
                 span_id: Optional[str] = None) -> None:
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.parent = parent
        # W3C span id: pre-generated by the transport for wire attempts
        # (the traceparent header must carry it BEFORE the attempt
        # completes), random otherwise
        self.span_id = span_id or new_span_id()
        # args/children/events mutate after publication (annotate() from
        # the owning thread, child attachment from ANY thread via
        # explicit parent=) — all three share the tracer's lock
        self.args: Dict[str, Any] = dict(args)  # guarded-by: tracer.lock
        self.start_s = time.monotonic() - tracer.t0
        self.end_s: Optional[float] = None
        self.tid = threading.get_ident()
        self.children: List[Span] = []  # guarded-by: tracer.lock
        # (name, offset_s, args) instant events within this span
        # guarded-by: tracer.lock
        self.events: List[Tuple[str, float, Dict[str, Any]]] = []

    def annotate(self, key: str, value: Any) -> None:
        with self.tracer.lock:
            self.args[key] = value

    def event(self, name: str, **args: Any) -> None:
        offset = time.monotonic() - self.tracer.t0
        with self.tracer.lock:
            self.events.append((name, offset, dict(args)))
        rec = self.tracer.recorder
        if rec is not None:
            # instant events (retry/backoff/chaos marks) are the flight
            # recorder's most valuable cargo: flushed urgently so a
            # SIGKILL right after a retry still leaves it on disk
            rec.record({"ph": "i", "name": name, "cat": self.cat,
                        "ts_s": round(offset, 6), "tid": self.tid,
                        "args": dict(args)}, urgent=True)

    def end(self) -> None:
        if self.end_s is None:
            self.end_s = time.monotonic() - self.tracer.t0
            self._record_end()
            self.tracer._discard_ended_root(self)

    def _record_end(self) -> None:
        """Feed the flight recorder one completed-span record (called
        from end() and from Tracer.leaf, which sets end_s directly)."""
        rec = self.tracer.recorder
        if rec is None or self.end_s is None:
            return
        with self.tracer.lock:
            args = dict(self.args)
        rec.record({"ph": "X", "name": self.name, "cat": self.cat,
                    "ts_s": round(self.start_s, 6),
                    "dur_s": round(self.end_s - self.start_s, 6),
                    "tid": self.tid, "span_id": self.span_id,
                    "args": args})

    @property
    def duration_s(self) -> float:
        end = (self.end_s if self.end_s is not None
               else time.monotonic() - self.tracer.t0)
        return max(0.0, end - self.start_s)


class _SpanScope:
    """Context manager: pushes the span on the calling thread's stack so
    nested instrumentation (HTTP attempts inside an object apply) parents
    correctly, pops + ends on exit."""

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self._tracer.push(self.span)
        return self.span

    def __exit__(self, *exc: object) -> None:
        self._tracer.pop(self.span)
        self.span.end()


class _NullScope:
    """The no-telemetry stand-in :func:`maybe_span` hands out."""

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> None:
        return None


class Tracer:
    def __init__(self) -> None:
        self.t0 = time.monotonic()
        # epoch anchor so two traces (or a trace and a server log) can be
        # aligned on wall-clock time
        self.epoch = time.time()
        # (time.time_ns(), time.monotonic_ns()) read together: what
        # wall_ns() converts span offsets with (reanchor())
        self.anchor: Tuple[int, int] = (0, 0)
        self.reanchor()
        # one trace id per tracer: every traceparent this process sends
        # (and every annotation it stamps) carries it, which is what lets
        # `tpuctl trace merge` correlate three processes' timelines
        self.trace_id = new_trace_id()
        # optional FlightRecorder fed on span end / instant events; set
        # once before instrumentation starts (the Telemetry constructor),
        # read by every recording thread
        self.recorder: Optional["FlightRecorder"] = None
        # span retention: True keeps every finished span for a later
        # chrome_trace()/write_trace() export (one-shot rollouts); False
        # drops a finished parentless span (and with it its whole
        # subtree) — the mode for long-running controllers whose trace
        # is never exported, where retaining every pass's tree would
        # grow without bound. Set once before instrumentation starts
        # (the Telemetry constructor), like `recorder`.
        self.retain_spans = True
        self.lock: Any = threading.Lock()
        self.roots: List[Span] = []  # guarded-by: lock
        self._tls = threading.local()  # thread-owned (per-thread stack)

    # ---------------------------------------------------------- clock

    def reanchor(self) -> None:
        """Pair the wall clock with the monotonic one anew: the tightest
        of three back-to-back reads, the wall read against the midpoint of
        the two monotonic reads around it. Call it near the spans to be
        converted, so that the wall clock's slew since cannot move them."""
        best = None
        for _ in range(3):
            m0 = time.monotonic_ns()
            wall = time.time_ns()
            m1 = time.monotonic_ns()
            if best is None or m1 - m0 < best[0]:
                best = (m1 - m0, wall, (m0 + m1) // 2)
        self.anchor = (best[1], best[2])

    def wall_ns(self, offset_s: float) -> int:
        """A span offset (seconds after ``t0``, as ``Span.start_s`` and
        ``end_s``) on ``time.time_ns()``'s clock, the one the torch
        profiler stamps its events with."""
        wall, mono = self.anchor
        return wall + round((self.t0 + offset_s) * 1e9) - mono

    # ---------------------------------------------------- span lifecycle

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack  # type: ignore[no-any-return]

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def push(self, span: Span) -> None:
        self._stack().append(span)

    def pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()

    def start(self, name: str, cat: str, parent: Optional[Span] = None,
              span_id: Optional[str] = None, **args: Any) -> Span:
        """Create (and attach) a span; caller must ``end()`` it. Parent
        resolution: explicit ``parent`` wins (thread boundaries), else the
        calling thread's innermost open span, else a new root."""
        if parent is None:
            parent = self.current()
        span = Span(self, name, cat, parent, args, span_id=span_id)
        if parent is not None:
            # phrased receiver-locally (parent.tracer IS this tracer):
            # child attachment happens under the lock guarding
            # Span.children, whichever thread performs it
            with parent.tracer.lock:
                parent.children.append(span)
        else:
            with self.lock:
                self.roots.append(span)
        return span

    def span(self, name: str, cat: str, parent: Optional[Span] = None,
             **args: Any) -> _SpanScope:
        return _SpanScope(self, self.start(name, cat, parent, **args))

    def leaf(self, name: str, cat: str, duration_s: float,
             parent: Optional[Span] = None,
             span_id: Optional[str] = None, **args: Any) -> Span:
        """Record an already-completed leaf span ending NOW (wire attempts
        are timed by the transport and reported after the fact;
        ``span_id`` is the id the transport already sent in the attempt's
        traceparent header, so server-side spans can name it)."""
        span = self.start(name, cat, parent, span_id=span_id, **args)
        span.start_s = max(0.0, span.start_s - max(0.0, duration_s))
        span.end_s = span.start_s + max(0.0, duration_s)
        span._record_end()
        self._discard_ended_root(span)
        return span

    def _discard_ended_root(self, span: Span) -> None:
        """With retention off, a finished parentless span is dropped
        from ``roots`` — the flight recorder (already fed on end) and
        the metrics registry are the bounded surfaces that remain."""
        if self.retain_spans or span.parent is not None:
            return
        with self.lock:
            try:
                self.roots.remove(span)
            except ValueError:
                pass

    def event(self, name: str, **args: Any) -> None:
        """Instant event on the calling thread's innermost open span
        (dropped when no span is open — a bare Client call outside any
        rollout)."""
        cur = self.current()
        if cur is not None:
            cur.event(name, **args)

    # ---------------------------------------------------------- export

    def walk(self) -> Iterator[Span]:
        with self.lock:
            stack = list(self.roots)
        while stack:
            span = stack.pop()
            yield span
            with span.tracer.lock:
                stack.extend(span.children)

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event format (the JSON object form):
        ``{"traceEvents": [...], "displayTimeUnit": "ms"}``. One ``X``
        (complete) event per span — ``ts``/``dur`` in MICROSECONDS, as the
        format requires — and one ``i`` (instant) event per span event.
        Unfinished spans export with their duration so far and
        ``args.unfinished = true`` (a crashed rollout's trace is the most
        interesting one)."""
        events: List[Dict[str, Any]] = []
        now = time.monotonic() - self.t0
        for span in self.walk():
            # copy the mutable span state under its lock: exporting a
            # LIVE trace (the failure path writes mid-rollout) must not
            # race annotate()/event() on still-running spans
            with span.tracer.lock:
                args = dict(span.args)
                span_events = list(span.events)
            end = span.end_s if span.end_s is not None else now
            if span.end_s is None:
                args["unfinished"] = True
            # every span exports its W3C span id: the server-side spans'
            # parent_id values resolve against these (the traceparent
            # traceparent parity pin)
            args["span_id"] = span.span_id
            events.append({
                "name": span.name, "cat": span.cat, "ph": "X",
                "ts": round(span.start_s * 1e6, 1),
                "dur": round(max(0.0, end - span.start_s) * 1e6, 1),
                "pid": 1, "tid": span.tid, "args": args,
            })
            for ev_name, offset, ev_args in span_events:
                events.append({
                    "name": ev_name, "cat": span.cat, "ph": "i", "s": "t",
                    "ts": round(offset * 1e6, 1),
                    "pid": 1, "tid": span.tid, "args": dict(ev_args),
                })
        events.sort(key=lambda e: (e["ts"], e["ph"] != "X"))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"producer": "tpuctl",
                              "trace_id": self.trace_id,
                              "epoch": self.epoch}}


def _atomic_write(path: str, text: str) -> None:
    """Write ``text`` to ``path`` via temp-file + rename, so a SIGKILL at
    any instant leaves either the previous file or the complete new one —
    never torn JSON (the journal's torn-tail discipline, applied to every
    telemetry output). The scratch file comes from ``tempfile.mkstemp``
    (O_CREAT|O_EXCL, random name, 0600): a predictable temp name in a
    shared directory would be symlink-plantable (CWE-377), and the
    flight recorder's default lives in exactly such a directory."""
    import tempfile
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        prefix=f".{os.path.basename(path)}.", suffix=".tmp",
        dir=directory)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_json(path: str, doc: Dict[str, Any]) -> None:
    """Atomically write one JSON document (compact, trailing newline) —
    the public face of :func:`_atomic_write` for trace files."""
    _atomic_write(path, json.dumps(doc, separators=(",", ":")) + "\n")


class FlightRecorder:
    """Bounded always-on post-mortem trace: a ring of the last
    ``capacity`` span/instant-event records, rewritten ATOMICALLY to
    ``path`` — urgently on every instant event (retries are the cargo a
    post-mortem needs), else every ``flush_every`` records. Because the
    on-disk file is replaced via rename, a SIGKILL at any instant leaves
    a parseable dump (at worst ``flush_every`` spans stale); crash /
    SIGTERM / chaos-failure paths flush explicitly. The dump is a Chrome
    trace-event document (``otherData.flight_recorder: true``) so the
    same tools — Perfetto, ``tpuctl top``, ``tpuctl trace merge`` — read
    it."""

    def __init__(self, path: str, trace_id: str = "",
                 capacity: int = 256, flush_every: int = 16) -> None:
        self.path = path
        self.trace_id = trace_id
        self.capacity = max(1, capacity)
        self.flush_every = max(1, flush_every)
        self.epoch = time.time()
        self._lock: Any = threading.Lock()
        self._ring: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._since_flush = 0  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock

    def record(self, rec: Dict[str, Any], urgent: bool = False) -> None:
        with self._lock:
            self._ring.append(rec)
            overflow = len(self._ring) - self.capacity
            if overflow > 0:
                del self._ring[:overflow]
                self._dropped += overflow
            self._since_flush += 1
            flush = urgent or self._since_flush >= self.flush_every
        if flush:
            self.flush()

    def document(self) -> Dict[str, Any]:
        """The ring as a Chrome trace-event document (best-effort times:
        ts/dur come from the recorded offsets)."""
        with self._lock:
            ring = list(self._ring)
            dropped = self._dropped
        events: List[Dict[str, Any]] = []
        for rec in ring:
            ev: Dict[str, Any] = {
                "name": rec.get("name", "?"), "cat": rec.get("cat", "?"),
                "ph": rec.get("ph", "X"),
                "ts": round(float(rec.get("ts_s", 0.0)) * 1e6, 1),
                "pid": 1, "tid": rec.get("tid", 0),
                "args": dict(rec.get("args") or {}),
            }
            if ev["ph"] == "X":
                ev["dur"] = round(float(rec.get("dur_s", 0.0)) * 1e6, 1)
                if "span_id" in rec:
                    ev["args"]["span_id"] = rec["span_id"]
            else:
                ev["s"] = "t"
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"producer": "tpuctl-flight-recorder",
                              "flight_recorder": True,
                              "trace_id": self.trace_id,
                              "capacity": self.capacity,
                              # same key as the C++ twin emitter's
                              # otherData (kubeapi::TraceEmitter):
                              # records evicted from the bounded ring
                              "dropped_events": dropped,
                              "epoch": self.epoch}}

    def flush(self) -> None:
        """Atomically rewrite the on-disk dump from the current ring.
        Best-effort by design: an unwritable path must never fail the
        rollout the recorder exists to debug."""
        try:
            _atomic_write(self.path,
                          json.dumps(self.document(),
                                     separators=(",", ":")) + "\n")
        except OSError:
            pass
        with self._lock:
            self._since_flush = 0


class Telemetry:
    """The facade instrumented code holds: one tracer + one registry
    (+ optionally one flight recorder fed by the tracer)."""

    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 retain_spans: bool = True) -> None:
        self.tracer = Tracer()
        self.tracer.retain_spans = retain_spans
        self.metrics = MetricsRegistry()
        self.recorder = recorder
        if recorder is not None:
            if not recorder.trace_id:
                recorder.trace_id = self.tracer.trace_id
            self.tracer.recorder = recorder

    # tracing delegates
    def span(self, name: str, cat: str, parent: Optional[Span] = None,
             **args: Any) -> _SpanScope:
        return self.tracer.span(name, cat, parent, **args)

    def leaf(self, name: str, cat: str, duration_s: float,
             parent: Optional[Span] = None,
             span_id: Optional[str] = None, **args: Any) -> Span:
        return self.tracer.leaf(name, cat, duration_s, parent,
                                span_id=span_id, **args)

    def current(self) -> Optional[Span]:
        return self.tracer.current()

    def event(self, name: str, **args: Any) -> None:
        self.tracer.event(name, **args)

    # metrics delegates
    def counter(self, name: str, help_text: str = "",
                **labels: str) -> Counter:
        return self.metrics.counter(name, help_text, **labels)

    def gauge(self, name: str, help_text: str = "", **labels: str) -> Gauge:
        return self.metrics.gauge(name, help_text, **labels)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        return self.metrics.histogram(name, help_text, buckets=buckets,
                                      **labels)

    # export — both writes are ATOMIC (temp + rename): a SIGKILL mid-dump
    # must leave the previous file or the complete new one, never torn
    # JSON/exposition text (the journal's torn-tail discipline)
    def chrome_trace(self) -> Dict[str, Any]:
        return self.tracer.chrome_trace()

    def write_trace(self, path: str) -> None:
        _atomic_write(path, json.dumps(self.chrome_trace(),
                                       separators=(",", ":")) + "\n")

    def write_metrics(self, path: str) -> None:
        _atomic_write(path, self.metrics.render())


def maybe_span(tel: Optional[Telemetry], name: str, cat: str,
               parent: Optional[Span] = None,
               **args: Any) -> Union[_SpanScope, _NullScope]:
    """Span scope when telemetry is enabled, a no-op scope otherwise —
    instrumented call sites stay one-liners with zero overhead off."""
    if tel is None:
        return _NullScope()
    return tel.span(name, cat, parent, **args)


# --------------------------------------------------------------------------
# Trace summarization (`tpuctl top`).

# Rollout phase names in canonical order (the timings_line order); the
# summary and the bench both filter phase spans to this set.
PHASE_NAMES: Tuple[str, ...] = ("apply", "crd-establish", "ready-wait")


def _complete_events(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    if not isinstance(trace, dict):
        raise ValueError("not a Chrome trace: top-level JSON is not an "
                         "object")
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("not a Chrome trace: no traceEvents array")
    return [e for e in events
            if isinstance(e, dict) and e.get("ph") == "X"]


def phase_totals(trace: Dict[str, Any]) -> Dict[str, float]:
    """Summed wall seconds per rollout phase (cat == "phase", canonical
    names only) — what the bench derives its phases column from."""
    out = {name: 0.0 for name in PHASE_NAMES}
    for e in _complete_events(trace):
        if e.get("cat") == "phase" and e.get("name") in out:
            out[str(e["name"])] += float(e.get("dur", 0.0)) / 1e6
    return out


def request_events(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every HTTP wire-attempt span (cat == "http") in the trace."""
    return [e for e in _complete_events(trace) if e.get("cat") == "http"]


def summarize_trace(trace: Dict[str, Any], limit: int = 10) -> str:
    """Human breakdown of a saved rollout trace: per-phase totals,
    request counts by verb/status, retry marks, and the slowest object /
    request spans — the `tpuctl top` renderer. Merged multi-process
    traces (`tpuctl trace merge`) list their per-process tracks first."""
    complete = _complete_events(trace)
    if not complete:
        raise ValueError("trace has no complete (ph=X) span events")
    lines: List[str] = []
    processes = {e.get("pid"): e.get("args", {}).get("name", "?")
                 for e in trace.get("traceEvents", [])
                 if isinstance(e, dict) and e.get("ph") == "M"
                 and e.get("name") == "process_name"}
    if processes:
        by_pid: Dict[Any, int] = {}
        for e in complete:
            by_pid[e.get("pid")] = by_pid.get(e.get("pid"), 0) + 1
        lines.append("processes (merged trace):")
        for pid, name in sorted(processes.items(),
                                key=lambda kv: str(kv[0])):
            lines.append(f"  pid {pid}: {name} "
                         f"({by_pid.get(pid, 0)} span(s))")
        lines.append("")
    rollouts = [e for e in complete if e.get("cat") == "rollout"]
    for r in rollouts:
        lines.append(f"rollout: {r.get('dur', 0.0) / 1e6:.3f}s "
                     f"({json.dumps(r.get('args', {}), sort_keys=True)})")
    lines.append("")
    lines.append("phase breakdown (summed across groups):")
    for name, secs in phase_totals(trace).items():
        lines.append(f"  {name:<14} {secs:8.3f}s")
    reqs = request_events(trace)
    by_verb: Dict[str, int] = {}
    by_status: Dict[str, int] = {}
    for e in reqs:
        args = e.get("args", {})
        verb = str(args.get("verb", "?"))
        by_verb[verb] = by_verb.get(verb, 0) + 1
        status = str(args.get("status", "?"))
        by_status[status] = by_status.get(status, 0) + 1
    lines.append("")
    verb_text = ", ".join(f"{v} {n}" for v, n in sorted(by_verb.items()))
    status_text = ", ".join(
        f"{s}: {n}" for s, n in sorted(by_status.items()))
    lines.append(f"requests: {len(reqs)} ({verb_text})")
    lines.append(f"  by status: {status_text}")
    instants = [e for e in trace["traceEvents"]
                if isinstance(e, dict) and e.get("ph") == "i"]
    retries = [e for e in instants if e.get("name") == "retry"]
    if retries:
        lines.append(f"  retries: {len(retries)} "
                     "(see instant events in the trace)")
    if instants:
        # instant events (retry/hedge/chaos marks, admission results)
        # are the trace's "what happened" annotations — a summary that
        # drops them hides exactly the interesting runs
        by_name: Dict[str, int] = {}
        for e in instants:
            n = str(e.get("name", "?"))
            by_name[n] = by_name.get(n, 0) + 1
        lines.append("")
        lines.append("instant events (by name):")
        for n, count in sorted(by_name.items()):
            lines.append(f"  {n:<22} {count:6d}")
    lines.append("")
    lines.append(f"slowest spans (top {limit}):")
    interesting = [e for e in complete
                   if e.get("cat") in ("apply", "http", "watch", "group")]
    interesting.sort(key=lambda e: -float(e.get("dur", 0.0)))
    for e in interesting[:limit]:
        status = e.get("args", {}).get("status", "")
        suffix = f"  [{status}]" if status != "" else ""
        lines.append(f"  {float(e.get('dur', 0.0)) / 1e6:8.3f}s  "
                     f"{e.get('cat', '?'):<6} {e.get('name', '?')}{suffix}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# Multi-process trace assembly (`tpuctl trace merge`) + schema validation.


def validate_chrome_trace(trace: Any) -> int:
    """Validate a document against the Chrome trace-event JSON object
    format (the subset every producer in this repo emits): a dict with a
    ``traceEvents`` list of event dicts, each carrying string ``name`` /
    ``ph`` and numeric ``ts``; ``X`` events need a numeric non-negative
    ``dur``; ``pid``/``tid`` must be ints where present. Raises
    ValueError naming the first offending event; returns the event count
    (the CI artifact gate calls this on the merged file)."""
    events = _complete_events(trace)  # raises on non-dict / no traceEvents
    all_events = trace["traceEvents"]
    for i, e in enumerate(all_events):
        if not isinstance(e, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        where = f"traceEvents[{i}] ({e.get('name')!r})"
        if not isinstance(e.get("name"), str):
            raise ValueError(f"{where}: name is not a string")
        if not isinstance(e.get("ph"), str) or not e["ph"]:
            raise ValueError(f"{where}: ph is not a string")
        if not isinstance(e.get("ts"), (int, float)):
            raise ValueError(f"{where}: ts is not a number")
        for key in ("pid", "tid"):
            if key in e and not isinstance(e[key], int):
                raise ValueError(f"{where}: {key} is not an int")
        if e["ph"] == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: X event without a "
                                 "non-negative numeric dur")
        if "args" in e and not isinstance(e["args"], dict):
            raise ValueError(f"{where}: args is not an object")
    return len(events)


def merge_traces(docs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Assemble several single-process Chrome traces (the CLI's
    ``--trace-out``, the fake apiserver's ``/__fake_trace``, the C++
    operator's ``--trace-out``) into ONE Perfetto timeline:

    - each input becomes its own process track (pid = input index + 1)
      named by its ``otherData.producer`` via a ``process_name`` metadata
      event;
    - timelines are aligned on the producers' ``otherData.epoch`` anchors
      (each trace's ts values are offsets from its own start): everything
      is shifted onto the EARLIEST epoch so "what was the server doing
      while the CLI retried" reads straight off the time axis;
    - trace ids are NOT rewritten — correlation is the ids' job
      (``args.trace_id`` / ``args.span_id`` / ``args.parent_id``), and
      ``otherData.trace_ids`` lists every input's primary id.
    """
    if not docs:
        raise ValueError("merge_traces: no input traces")
    epochs: List[float] = []
    for doc in docs:
        other = doc.get("otherData") or {}
        epochs.append(float(other.get("epoch") or 0.0))
    known = [e for e in epochs if e > 0]
    base = min(known) if known else 0.0
    out_events: List[Dict[str, Any]] = []
    producers: List[str] = []
    trace_ids: List[str] = []
    for i, doc in enumerate(docs):
        pid = i + 1
        other = doc.get("otherData") or {}
        producer = str(other.get("producer") or f"process-{pid}")
        producers.append(producer)
        tid = str(other.get("trace_id") or "")
        if tid:
            trace_ids.append(tid)
        shift_us = ((epochs[i] - base) * 1e6
                    if epochs[i] > 0 and base > 0 else 0.0)
        out_events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "ts": 0,
                           "args": {"name": producer}})
        validate_chrome_trace(doc)
        for e in doc["traceEvents"]:
            ev = dict(e)
            ev["pid"] = pid
            ev["ts"] = round(float(e.get("ts", 0.0)) + shift_us, 1)
            out_events.append(ev)
    out_events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    return {"traceEvents": out_events, "displayTimeUnit": "ms",
            "otherData": {"producer": "tpuctl trace merge",
                          "merged_from": producers,
                          "trace_ids": sorted(set(trace_ids)),
                          "epoch": base}}
