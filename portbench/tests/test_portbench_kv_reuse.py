"""The decode step's K/V cache reuse (``kv_reuse.*``) on hand-made
dispatch spans: the cached share of the attended rows inside the window,
and nothing where no span carries the annotations."""

from __future__ import annotations

import pytest

from portbench import harness, spans
from tpu_cluster_torch import telemetry

DISPATCH = telemetry.SERVING_SPANS[4]
ITERATION = telemetry.SERVING_SPANS[0]


def _record(mode, made):
    return {"mode": mode, "spans": made,
            "timeline": spans.Timeline(window=(100, 1000), busy=[], ops=[])}


def _dispatch(start, **args):
    return spans.SpanTime(DISPATCH, start, start + 10, args)


SPANS = [
    _dispatch(50, projected_rows=9000, cached_rows=0),     # before the window
    _dispatch(200, projected_rows=1500, cached_rows=0),    # a prefill
    _dispatch(300, projected_rows=2, cached_rows=2998),
    spans.SpanTime(ITERATION, 290, 320, {"seated": 2}),
    _dispatch(995, projected_rows=2, cached_rows=3000),    # ends past it
]


@pytest.mark.parametrize("name,mode", [("kv_reuse.offline", "saturated"),
                                       ("kv_reuse.online", "open")])
def test_reads_the_cached_share_of_the_windows_dispatches(name, mode):
    read = harness.reader(name)
    assert read(_record(mode, SPANS)) == pytest.approx(
        100.0 * 2998 / (1500 + 2 + 2998))
    # the other serving mode, a training record, an untraced run
    other = "open" if mode == "saturated" else "saturated"
    assert read(_record(other, SPANS)) is None
    assert read({"mode": mode}) is None


@pytest.mark.parametrize("name,mode", [("kv_reuse.offline", "saturated"),
                                       ("kv_reuse.online", "open")])
def test_reads_nothing_without_the_annotations(name, mode):
    """A decode that keeps no cache annotates its dispatch spans with
    ``tail_rows`` alone: the metric is left out of the line."""
    read = harness.reader(name)
    plain = [_dispatch(200 + 20 * i, tail_rows=4) for i in range(3)]
    assert read(_record(mode, plain)) is None
    assert read(_record(mode, [])) is None
