"""The port's own spans set against the device trace of a traced window.

The port records spans on its host's monotonic clock
(``tpu_cluster_torch.telemetry``): ``SERVING_SPANS`` in the serving
engine, armed by ``InferenceEngine(..., spans=True)``, and
``TRAIN_SPANS`` in ``burnin.train_step(..., telemetry=...)``.
``Tracer.wall_ns`` puts a span's offsets on ``time.time_ns()``'s clock,
which the torch profiler stamps its events with. The reductions here
take those spans and the profiler's events:

- :func:`timeline`: the window, the device's busy intervals (as
  ``trace.reduce`` finds them) and each device operation with the host
  host interval of the runtime call that launched it, by correlation id;
- :func:`idle_by_span`: the window's idle seconds by the innermost span
  that holds them, or ``OUTSIDE``;
- :func:`device_by_span`: device seconds of the operations by the
  innermost span that holds their launch. By time, not by thread:
  autograd launches the backward's kernels from a thread of its own
  while the caller waits in ``train.loss_and_grads``;
- :func:`host_turn_ms` and :func:`sgd_update_share`, the readings.

A traced run (``--trace 1``) arms the spans: the serving engine is built
with ``spans=True``, the window's training steps take ``telemetry=``,
and the record gains ``spans`` and ``timeline`` (:func:`record_keys`),
which the readers ``host_turn_ms.*`` and ``sgd_update_share.train``
take. An untraced run arms nothing. All the readings of one traced run:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

prints one line of them (:func:`readings`).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from portbench import harness, trace

OUTSIDE = "outside spans"
# how far before a span's start clock_bounds_us looks for its call
_SLACK_NS = 1_000_000
# host calls that launch device work: CUDA's cuda* and cu* entry points
_LAUNCH_PREFIX = "cu"


class SpanTime(NamedTuple):
    """A program span on the profiler's clock, in nanoseconds."""

    name: str
    start: int
    end: int
    args: Dict[str, Any]


@dataclass
class Timeline:
    """The window, the device's busy intervals and its operations, in
    profiler nanoseconds."""

    window: Tuple[int, int]
    busy: List[Tuple[int, int]]
    # (start, end) clipped to the window, and the launching call's
    # (start, end) on the host (None where the trace holds no call of
    # the op's correlation id)
    ops: List[Tuple[int, int, Optional[Tuple[int, int]]]]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9


def program_spans(tracer) -> List[SpanTime]:
    """Every finished span of a port ``Tracer``, on the profiler's clock
    by its last ``reanchor()``."""
    return [SpanTime(s.name, tracer.wall_ns(s.start_s),
                     tracer.wall_ns(s.end_s), dict(s.args))
            for s in tracer.walk() if s.end_s is not None]


def timeline(events) -> Timeline:
    """The :class:`Timeline` of the profiler's events: the same window
    and device intervals as ``trace.reduce``."""
    from torch.autograd import DeviceType

    window = [e for e in events if e.name() == trace.WINDOW_SPAN
              and e.device_type() == DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"{len(window)} '{trace.WINDOW_SPAN}' spans in "
                           "the trace")
    w0 = window[0].start_ns()
    w1 = w0 + window[0].duration_ns()
    launches: Dict[int, Tuple[int, int]] = {}
    device: List[Tuple[int, int, int]] = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            if e.name().startswith(_LAUNCH_PREFIX):
                launches[e.correlation_id()] = (
                    e.start_ns(), e.start_ns() + e.duration_ns())
            continue
        start = e.start_ns()
        end = start + e.duration_ns()
        if end <= w0 or start >= w1 or trace._annotation(e) \
                or e.name() == trace.WINDOW_SPAN:
            continue
        device.append((max(start, w0), min(end, w1), e.correlation_id()))
    return Timeline(
        window=(w0, w1),
        busy=trace._union([(s, e) for s, e, _ in device]),
        ops=[(s, e, launches.get(c)) for s, e, c in device])


def _segments(spans: List[SpanTime]) -> List[Tuple[int, int, str]]:
    """The spans' union cut where any span starts or ends, each piece
    with the name of the innermost (shortest) span that holds it."""
    points = sorted({t for s in spans for t in (s.start, s.end)})
    order = sorted(spans, key=lambda s: s.start)
    out: List[Tuple[int, int, str]] = []
    active: List[SpanTime] = []
    i = 0
    for a, b in zip(points, points[1:]):
        while i < len(order) and order[i].start <= a:
            active.append(order[i])
            i += 1
        active = [s for s in active if s.end >= b]
        if active:
            inner = min(active, key=lambda s: s.end - s.start)
            out.append((a, b, inner.name))
    return out


def _gaps(tl: Timeline) -> List[Tuple[int, int]]:
    out, prev = [], tl.window[0]
    for s, e in tl.busy:
        if s > prev:
            out.append((prev, s))
        prev = e
    if prev < tl.window[1]:
        out.append((prev, tl.window[1]))
    return out


def idle_by_span(tl: Timeline, spans: List[SpanTime]) -> Dict[str, float]:
    """The window's idle seconds by the innermost span holding them."""
    segs = _segments(spans)
    out: Dict[str, float] = {}
    j = 0
    for g0, g1 in _gaps(tl):
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        held = 0
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b, name = segs[k]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part * 1e-9
                held += part
            k += 1
        if g1 - g0 > held:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (g1 - g0 - held) * 1e-9
    return out


def device_by_span(tl: Timeline, spans: List[SpanTime]) -> Dict[str, float]:
    """Device seconds of the window's operations by the innermost span
    that holds the host call that launched each; ``OUTSIDE`` where no
    span holds it or the trace has no such call."""
    segs = _segments(spans)
    starts = [a for a, _, _ in segs]
    out: Dict[str, float] = {}
    for s, e, call in tl.ops:
        name = OUTSIDE
        if call is not None:
            k = bisect.bisect_right(starts, call[0]) - 1
            if k >= 0 and call[0] <= segs[k][1]:
                name = segs[k][2]
        out[name] = out.get(name, 0.0) + (e - s) * 1e-9
    return out


def busy_within(tl: Timeline, start: int, end: int) -> int:
    """Nanoseconds of ``[start, end]`` in which the device was busy."""
    total = 0
    i = max(bisect.bisect_right(tl.busy, (start, start)) - 1, 0)
    while i < len(tl.busy) and tl.busy[i][0] < end:
        s, e = tl.busy[i]
        total += max(0, min(e, end) - max(s, start))
        i += 1
    return total


def clock_bounds_us(tl: Timeline, spans: List[SpanTime], sync: str
                    ) -> Optional[Tuple[float, float]]:
    """Bounds, in us, on how far the spans' clock lies ahead of the
    trace's: the host call that waits for the device in each ``sync``
    span (the longest call launched in it) must lie inside the span, so
    the offset is at least minus its lead from the span's start and at
    most its tail to the span's end, over every such span."""
    calls = sorted(c for _, _, c in tl.ops if c is not None)
    starts = [c[0] for c in calls]
    low, high = None, None
    for s in spans:
        if s.name != sync:
            continue
        i = bisect.bisect_left(starts, s.start - _SLACK_NS)
        j = bisect.bisect_right(starts, s.end)
        if i == j:
            continue
        c0, c1 = max(calls[i:j], key=lambda c: c[1] - c[0])
        lead, tail = c0 - s.start, s.end - c1
        low = -lead if low is None else max(low, -lead)
        high = tail if high is None else min(high, tail)
    return None if low is None else (low * 1e-3, high * 1e-3)


def _within_window(tl: Timeline, spans: List[SpanTime], name: str
                   ) -> List[SpanTime]:
    w0, w1 = tl.window
    return [s for s in spans if s.name == name and w0 <= s.start
            and s.end <= w1]


def host_turn_ms(tl: Timeline, spans: List[SpanTime],
                 iteration: str) -> Optional[float]:
    """Mean over the window's decoding iteration spans of the span's
    length less the device-busy time inside it, in ms."""
    turns = [(s.end - s.start) - busy_within(tl, s.start, s.end)
             for s in _within_window(tl, spans, iteration)
             if s.args.get("seated", 0) > 0]
    return 1e-6 * sum(turns) / len(turns) if turns else None


def sgd_update_share(tl: Timeline, spans: List[SpanTime],
                     update: str) -> Optional[float]:
    """Device seconds of the operations launched inside ``update`` spans
    over the window's busy seconds, in %."""
    if not tl.busy or not any(s.name == update for s in spans):
        return None
    return 100.0 * device_by_span(tl, spans).get(update, 0.0) / tl.busy_s


def readings(tl: Timeline, spans: List[SpanTime], kind: str
             ) -> Dict[str, Any]:
    """What a traced run with the spans armed reads: for serving the
    host turn, the device's busy share of the sync spans and the idle
    inside iteration spans that their children name; for training the
    update's share; for both idle and device time by span."""
    from tpu_cluster_torch import telemetry

    out: Dict[str, Any] = {"window_s": (tl.window[1] - tl.window[0]) * 1e-9,
                           "busy_s": tl.busy_s,
                           "ops_unlinked": sum(1 for o in tl.ops
                                               if o[2] is None)}
    idle = idle_by_span(tl, spans)
    if kind == "train":
        step, _, update = telemetry.TRAIN_SPANS
        out["sgd_update_share"] = sgd_update_share(tl, spans, update)
        out["steps"] = len(_within_window(tl, spans, step))
    else:
        iteration, *children, _park = telemetry.SERVING_SPANS
        sync = children[4]
        out["host_turn_ms"] = host_turn_ms(tl, spans, iteration)
        out["iterations"] = sum(
            1 for s in _within_window(tl, spans, iteration)
            if s.args.get("seated", 0) > 0)
        # tokens of the iterations that ended in the window, as the
        # engine's decoded_tokens counts them
        w0, w1 = tl.window
        out["tokens_per_s"] = sum(
            s.args.get("seated", 0) for s in spans
            if s.name == iteration and w0 <= s.end <= w1) / (
                (w1 - w0) * 1e-9)
        syncs = _within_window(tl, spans, sync)
        length = sum(s.end - s.start for s in syncs)
        out["sync_busy_pct"] = (100.0 * sum(busy_within(tl, s.start, s.end)
                                            for s in syncs) / length
                                if length else None)
        out["clock_bounds_us"] = clock_bounds_us(tl, syncs, sync)
        # idle inside iteration spans, and the share a child names
        inside = sum(idle.get(n, 0.0) for n in [iteration, *children])
        out["iteration_idle_s"] = inside
        out["iteration_idle_named_pct"] = (
            100.0 * (inside - idle.get(iteration, 0.0)) / inside
            if inside else None)
    out["idle_by_span"] = idle
    out["device_by_span"] = device_by_span(tl, spans)
    return out


# ------------------------------------------------------- on the record


def record_keys(prof, tracer) -> Dict[str, Any]:
    """What a traced run adds to its record for the span readers:
    ``spans``, the program's finished spans on the profiler's clock,
    ``timeline``, the window's device intervals and launches, and
    ``clock_drift_us``, how far the spans' clock drifted from the
    profiler's while it ran (``trace.profiled``); nothing for an untraced
    run (``prof`` None)."""
    if prof is None:
        return {}
    return {"spans": program_spans(tracer),
            "timeline": timeline(prof.profiler.kineto_results.events()),
            "clock_drift_us": prof.clock_drift_ns * 1e-3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    started = time.perf_counter()
    cell = harness.load_cell(args.workload, args.seed, args.seconds, True)
    harness.pin_caches()
    harness.require_card(cell.chips)
    import torch

    rec = harness.driver(cell).run(cell, torch.device("cuda", 0),
                                   started)["record"]
    print(json.dumps({"spans": dict(
        readings(rec["timeline"], rec["spans"], rec["kind"]),
        clock_drift_us=rec["clock_drift_us"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
