"""The port's spans against a device trace (``portbench.spans``): on
hand-made spans, busy intervals and profiler events, and a whole armed
run on the CPU at toy sizes."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, spans, trace
from portbench.tests.tiny import tiny_cell
from tpu_cluster_torch import telemetry

ITERATION = telemetry.SERVING_SPANS[0]
STEP, LOSS_AND_GRADS, SGD_UPDATE = telemetry.TRAIN_SPANS


class Event:
    """What ``timeline`` and ``trace.reduce`` read of a profiler event."""

    def __init__(self, name, start, dur, device=DeviceType.CPU, corr=0,
                 annotation=False):
        self._v = (name, start, dur, device, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def kernel(name, start, dur, corr):
    return Event(name, start, dur, DeviceType.CUDA, corr)


EVENTS = [
    Event(trace.WINDOW_SPAN, 1000, 1000, annotation=True),
    Event(trace.WINDOW_SPAN, 1000, 1000, DeviceType.CUDA, annotation=True),
    Event("aten::mm", 1010, 30, corr=7),
    Event("cudaLaunchKernel", 1020, 5, corr=7),
    Event("cudaLaunchKernel", 1100, 5, corr=8),
    Event("cudaMemcpyAsync", 1500, 300, corr=9),
    kernel("gemm", 1050, 200, 7),
    kernel("add", 1200, 100, 8),       # overlaps the gemm
    kernel("copy", 1900, 300, 9),      # runs past the window's end
    kernel("early", 900, 50, 6),       # before the window
]


def test_timeline_agrees_with_reduce_and_links_launches():
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: EVENTS)))
    dev = trace.reduce(prof)
    tl = spans.timeline(EVENTS)
    assert tl.window == (1000, 2000)
    assert tl.busy == [(1050, 1300), (1900, 2000)]
    assert tl.busy_s == pytest.approx(dev.busy_s)
    assert (tl.window[1] - tl.window[0]) * 1e-9 == pytest.approx(dev.window_s)
    assert [(e - s) * 1e-9 for s, e, _ in tl.ops] \
        == pytest.approx([d for _, d in dev.ops])
    assert [call for _, _, call in tl.ops] \
        == [(1020, 1025), (1100, 1105), (1500, 1800)]


def span(name, start, end, **args):
    return spans.SpanTime(name, start, end, args)


def test_host_turn_is_the_iteration_less_the_busy_inside_it():
    tl = spans.Timeline(window=(0, 1000), busy=[(20, 60), (150, 180)],
                        ops=[])
    made = [span(ITERATION, 0, 100, seated=2),
            span(ITERATION, 100, 200, seated=1),
            span(ITERATION, 200, 210, seated=0),     # decoded nothing
            span(ITERATION, 990, 1010, seated=1)]    # past the window
    assert spans.host_turn_ms(tl, made, ITERATION) == pytest.approx(65e-6)
    assert spans.host_turn_ms(tl, made[2:3], ITERATION) is None


def test_update_share_attributes_by_launch_not_by_run_time():
    """The update's kernel runs after its span has ended (the host runs
    ahead); it still counts for the update."""
    made = [span(STEP, 0, 200), span(LOSS_AND_GRADS, 0, 100),
            span(SGD_UPDATE, 100, 200)]
    tl = spans.Timeline(window=(0, 1000), busy=[(100, 400)],
                        ops=[(100, 300, (50, 55)), (300, 400, (150, 152)),
                             (350, 360, None)])
    assert spans.sgd_update_share(tl, made, SGD_UPDATE) \
        == pytest.approx(100 * 100 / 300)
    by = spans.device_by_span(tl, made)
    assert by == pytest.approx({LOSS_AND_GRADS: 200e-9, SGD_UPDATE: 100e-9,
                                spans.OUTSIDE: 10e-9})
    assert spans.sgd_update_share(tl, made[:2], SGD_UPDATE) is None


def test_idle_goes_to_the_innermost_span_holding_it():
    made = [span("outer", 0, 100), span("inner", 40, 60),
            span("later", 150, 170)]
    tl = spans.Timeline(window=(0, 200), busy=[(10, 30), (160, 200)],
                        ops=[])
    assert spans.idle_by_span(tl, made) == pytest.approx(
        {"outer": 60e-9, "inner": 20e-9, "later": 10e-9,
         spans.OUTSIDE: 50e-9})
    assert spans.busy_within(tl, 0, 100) == 20
    assert spans.busy_within(tl, 25, 165) == 10


SPAN_READERS = {"train": ["sgd_update_share.train"],
                "open": ["host_turn_ms.online"],
                "saturated": ["host_turn_ms.offline"]}


def _tiny_run(name, traced):
    cell = tiny_cell(name)
    cell.trace = traced
    torch.manual_seed(0)
    out = harness.driver(cell).run(cell, torch.device("cpu"),
                                   time.perf_counter())
    assert out["attempted"] > 0 and out["failed"] == 0
    return cell, out


@pytest.mark.parametrize("name", ["gptj6b-train-s2048", "gptj6b-serve-poisson",
                                  "mpt7b8k-serve-offline"])
def test_a_traced_run_on_the_cpu_carries_the_spans(name):
    """A traced run's record carries the program's spans inside its
    window and the timeline; the span readers read it, and read nothing
    in an untraced run's record."""
    cell, out = _tiny_run(name, True)
    rec = out["record"]
    tl, made = rec["timeline"], rec["spans"]
    w0, w1 = tl.window
    # the wall clock against the monotonic one over a second's window
    assert abs(rec["clock_drift_us"]) < 1000
    names = {s.name for s in made}
    kind = cell.traffic["kind"]
    if kind == "train":
        assert names == set(telemetry.TRAIN_SPANS)
        assert spans.readings(tl, made, "train")["steps"] == out["attempted"]
        # the CPU has no device operations: plant one a span, launched
        # where the span runs, so that the update's share is read
        parts = [s for s in made if s.name in (LOSS_AND_GRADS, SGD_UPDATE)
                 and w0 <= s.start and s.end <= w1]
        assert parts
        rec = dict(rec, timeline=spans.Timeline(
            window=tl.window, busy=trace._union([(s.start, s.end)
                                                 for s in parts]),
            ops=[(s.start, s.end, (s.start, s.start + 1)) for s in parts]))
        want = 100.0 * sum(s.end - s.start for s in parts
                           if s.name == SGD_UPDATE) / (
            sum(s.end - s.start for s in parts))
        assert harness.reader("sgd_update_share.train")(rec) \
            == pytest.approx(want, rel=0.05)
    else:
        assert set(telemetry.SERVING_SPANS[:7]) <= names
        assert any(s.name == ITERATION and w0 <= s.start and s.end <= w1
                   and s.args.get("seated", 0) > 0 for s in made)
    for metric in SPAN_READERS[kind]:
        value = harness.reader(metric)(rec)
        assert value is not None and value > 0, metric
    got = harness.read_metrics(cell.name, "per_layer", rec)
    assert set(SPAN_READERS[kind]) <= set(got)
    _, plain = _tiny_run(name, False)
    assert not {"spans", "timeline", "clock_drift_us"} & set(plain["record"])
    for metric in sum(SPAN_READERS.values(), []):
        assert harness.reader(metric)(plain["record"]) is None, metric


def test_clock_bounds_come_from_the_call_each_sync_waits_in():
    sync = telemetry.SERVING_SPANS[5]
    made = [span(sync, 100, 1000), span(sync, 2000, 3000)]
    tl = spans.Timeline(window=(0, 4000), busy=[],
                        ops=[(0, 1, (95, 97)), (0, 1, (110, 990)),
                             (0, 1, (2005, 2998)), (0, 1, None)])
    assert spans.clock_bounds_us(tl, made, sync) \
        == pytest.approx((-0.005, 0.002))
    assert spans.clock_bounds_us(tl, [], sync) is None
