"""Metrics half of ``tpu_cluster/telemetry.py``: a Prometheus-text
registry, dependency-free (stdlib only), the port's own copy.

:class:`MetricsRegistry` holds counter / gauge / histogram families keyed
by name, each with labeled children created on demand. Histograms use
FIXED buckets (cumulative ``le`` encoding, ``+Inf`` implicit) so two
processes observing the same distribution render byte-comparable bucket
lines. ``render()`` emits Prometheus text exposition format.

The serving families keep their ``tpu_serving_*`` names: the autoscaler
and the contract registry consume them. Tracing (spans, the flight
recorder, trace export) is not ported yet; :class:`Telemetry` here is
the metrics facade only.

Every lock in this module is leaf-only: nothing is acquired while one
is held.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple

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

# Fixed default buckets, request-latency shaped (seconds).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)

LabelPairs = Tuple[Tuple[str, str], ...]


def _label_pairs(labels: Dict[str, str]) -> LabelPairs:
    return tuple(sorted(labels.items()))


def escape_label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline) —
    the WRITE half of the exposition format's label grammar."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))



def _fmt(value: float) -> str:
    """Render a sample value: integers without a trailing .0, other
    floats rounded to 9 decimals."""
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(round(value, 9))


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


class Telemetry:
    """The facade instrumented code holds: one metrics registry."""

    def __init__(self) -> None:
        self.metrics = MetricsRegistry()

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
