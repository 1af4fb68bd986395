"""The port's telemetry (``tpu_cluster_torch.telemetry``) against the
reference's: the tracer half (spans, Chrome trace export, traceparent
helpers, the flight recorder) and the metrics half, alone and riding the
apply engine.

Compared exactly unless a test says otherwise: span names, categories
and nesting of the same rollout through each engine; the export's shape
(the reference's ``validate_chrome_trace`` must accept the port's
trace); the request counters; the flight recorder's records after a
failed rollout. Times are never compared. The registry's read
accessors (``total``, ``family_types``, ``Histogram.cumulative``) give
the reference's values, exactly, on the same observations.
"""

import json

import pytest

from fake_apiserver import FakeApiServer
from torch_apply_helpers import no_nagle  # noqa: F401
from tpu_cluster import kubeapply as ref_kubeapply
from tpu_cluster import telemetry as ref_telemetry
from tpu_cluster_torch import kubeapply, telemetry
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch.render import manifests, operator_bundle

ENGINES = ((ref_kubeapply, ref_telemetry), (kubeapply, telemetry))


@pytest.fixture(scope="module")
def groups():
    spec = specmod.default_spec()
    return (manifests.rollout_groups(spec)
            + operator_bundle.operator_install_groups(spec))


def tree(span, depth=0):
    """(depth, name, cat, sorted arg keys) of a span and its subtree,
    depth first in child order."""
    with span.tracer.lock:
        keys = tuple(sorted(span.args))
        kids = list(span.children)
    yield depth, span.name, span.cat, keys
    for child in kids:
        yield from tree(child, depth + 1)


def test_public_names_equal_the_reference():
    for name in ("OPERATOR_METRIC_NAMES", "TRACEPARENT_ANNOTATION",
                 "REQUESTS_TOTAL", "REQUEST_SECONDS", "RETRIES_TOTAL",
                 "HEDGES_TOTAL", "UNCHANGED_TOTAL", "READY_SECONDS",
                 "WATCH_RECONNECTS_TOTAL", "JOURNAL_SKIPS_TOTAL",
                 "VERIFY_KUBECTL_CALLS", "LIST_PAGES_TOTAL",
                 "EVENTS_EMITTED_TOTAL", "EVENTS_DROPPED_TOTAL",
                 "EVENT_EMIT_FAILURES_TOTAL", "SERVING_QUEUE_DEPTH",
                 "SERVING_TOKENS_TOTAL", "DEFAULT_BUCKETS", "PHASE_NAMES"):
        assert getattr(telemetry, name) == getattr(ref_telemetry, name), name


def test_traceparent_helpers_agree():
    for header in ("00-" + "a" * 32 + "-" + "b" * 16 + "-01",
                   "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
                   "00-0x" + "a" * 30 + "-" + "b" * 16 + "-01",
                   "garbage", " 00-" + "A" * 32 + "-" + "1" * 16 + "-00 "):
        assert telemetry.parse_traceparent(header) == \
            ref_telemetry.parse_traceparent(header)
    tid, sid = telemetry.new_trace_id(), telemetry.new_span_id()
    assert len(tid) == 32 and len(sid) == 16
    header = telemetry.format_traceparent(tid, sid)
    assert header == ref_telemetry.format_traceparent(tid, sid)
    assert ref_telemetry.parse_traceparent(header) == (tid, sid)


def test_span_stack_and_export_agree():
    docs = []
    for _, mod in ENGINES:
        tel = mod.Telemetry()
        with tel.span("rollout", "rollout", groups=2) as root:
            with tel.span("group-1", "group") as g:
                assert tel.current() is g
                g.event("retry", code=503, backoff_s=0.1)
                tel.leaf("GET /c", "http", 0.002, status=200, verb="GET")
            tel.tracer.start("threaded", "watch", parent=root).end()
        assert tel.current() is None
        tel.tracer.start("crashed", "rollout")
        doc = json.loads(json.dumps(tel.chrome_trace()))
        ref_telemetry.validate_chrome_trace(doc)
        docs.append([(e["ph"], e["name"], e["cat"], sorted(e["args"]))
                     for e in doc["traceEvents"]])
        assert doc["otherData"]["trace_id"] == tel.tracer.trace_id
    assert sorted(docs[1]) == sorted(docs[0])


def test_registry_renders_like_the_reference():
    texts = []
    for _, mod in ENGINES:
        reg = mod.MetricsRegistry()
        reg.counter("c_total", "a counter", verb="GET", code="200").inc(3)
        reg.gauge("g", "a gauge", path='we"ird\\').set(2.5)
        h = reg.histogram("h_seconds", "a histogram", verb="PATCH")
        for v in (0.0005, 0.003, 0.2, 7.0, 30.0):
            h.observe(v)
        texts.append(reg.render())
    assert texts[1] == texts[0]


def test_unretained_tracer_drops_finished_roots():
    tel = telemetry.Telemetry(retain_spans=False)
    with tel.span("pass", "reconcile"):
        tel.leaf("GET /x", "http", 0.001)
    assert tel.tracer.roots == []
    tel = telemetry.Telemetry()
    with tel.span("pass", "reconcile"):
        pass
    assert [s.name for s in tel.tracer.roots] == ["pass"]


def test_rollout_trace_has_the_reference_spans_and_nesting(groups):
    """One sequential rollout of the port's operand and operator groups
    through each engine with telemetry armed: the span trees are equal,
    the port's export passes the reference's schema check, and the
    request counters agree with the server's audit."""
    trees, counters, phases = [], [], []
    for kmod, tmod in ENGINES:
        tel = tmod.Telemetry()
        with FakeApiServer(auto_ready=True) as api:
            client = kmod.Client(api.url, telemetry=tel)
            try:
                kmod.apply_groups(client, groups, wait=True,
                                  stage_timeout=10, poll=0.02)
            finally:
                client.close()
            audit = len(api.log)
        [root] = tel.tracer.roots
        trees.append(list(tree(root)))
        doc = json.loads(json.dumps(tel.chrome_trace()))
        n = ref_telemetry.validate_chrome_trace(doc)
        assert n == len(trees[-1])
        assert len(tmod.request_events(doc)) == audit
        counters.append([line for line in tel.metrics.render().splitlines()
                         if line.startswith("tpuctl_requests_total")])
        phases.append(sorted(tmod.phase_totals(doc)))
    assert trees[1] == trees[0]
    assert counters[1] == counters[0]
    assert phases[1] == phases[0] == sorted(telemetry.PHASE_NAMES)
    names = [name for _, name, _, _ in trees[1]]
    assert names[0] == "rollout"
    assert [n for n in names if n.startswith("group-")] == [
        f"group-{i + 1}" for i in range(len(groups))]
    assert {"apply", "ready-wait", "crd-establish"} <= set(names)


def test_flight_recorder_dump_after_a_failed_rollout(groups, tmp_path):
    """A terminal 403 fails the rollout after two 503 retries; each
    engine's recorder, flushed on the failure path, holds the same
    records (the retry marks included) in a document the reference's
    schema check accepts."""
    dumps = []
    for kmod, tmod in ENGINES:
        path = tmp_path / f"{tmod.__name__}.json"
        recorder = tmod.FlightRecorder(str(path), capacity=64,
                                       flush_every=1000)
        tel = tmod.Telemetry(recorder=recorder)
        chaos = [{"status": 503, "method": "PATCH", "count": 2},
                 {"status": 403, "method": "PATCH",
                  "match": "daemonsets/gpu-device-plugin", "count": 1}]
        with FakeApiServer(auto_ready=True, chaos=chaos) as api:
            client = kmod.Client(api.url, telemetry=tel,
                                 retry=kmod.RetryPolicy(base_s=0.01,
                                                        cap_s=0.02))
            try:
                with pytest.raises(kmod.ApplyError, match="403"):
                    kmod.apply_groups(client, groups, wait=True,
                                      stage_timeout=10, poll=0.02)
            finally:
                client.close()
                recorder.flush()
        doc = json.loads(path.read_text())
        ref_telemetry.validate_chrome_trace(doc)
        assert doc["otherData"]["flight_recorder"] is True
        assert doc["otherData"]["trace_id"] == tel.tracer.trace_id
        dumps.append([(e["ph"], e["name"], e["cat"])
                      for e in doc["traceEvents"]])
    assert dumps[1] == dumps[0]
    assert sum(ph == "i" for ph, _, _ in dumps[1]) >= 2  # the retries


def test_write_outputs_are_atomic_and_parseable(tmp_path):
    tel = telemetry.Telemetry()
    with tel.span("rollout", "rollout"):
        tel.counter(telemetry.RETRIES_TOTAL, "retries", code="503").inc()
    tel.write_trace(str(tmp_path / "t.json"))
    tel.write_metrics(str(tmp_path / "m.prom"))
    telemetry.write_json(str(tmp_path / "w.json"), {"a": 1})
    assert ref_telemetry.validate_chrome_trace(
        json.loads((tmp_path / "t.json").read_text())) == 1
    assert 'tpuctl_retries_total{code="503"} 1' in (
        tmp_path / "m.prom").read_text()
    assert json.loads((tmp_path / "w.json").read_text()) == {"a": 1}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "m.prom", "t.json", "w.json"]  # no scratch file left behind
    with pytest.raises(OSError):
        tel.write_trace(str(tmp_path / "missing" / "t.json"))


def _observed_registry(tel):
    reg = tel.MetricsRegistry()
    for code, verb, n in (("200", "GET", 3), ("200", "PATCH", 2),
                          ("503", "GET", 4), ("429", "POST", 1)):
        reg.counter(tel.REQUESTS_TOTAL, "requests", code=code,
                    verb=verb).inc(n)
    reg.gauge(tel.SERVING_QUEUE_DEPTH, "queue").set(2.5)
    reg.gauge(tel.SERVING_QUEUE_DEPTH, "queue", job="b").set(-1.0)
    hist = reg.histogram(tel.REQUEST_SECONDS, "latency",
                         buckets=(0.01, 0.1, 1.0), verb="GET")
    for v in (0.001, 0.05, 0.05, 0.5, 7.0):
        hist.observe(v)
    reg.histogram(tel.REQUEST_SECONDS, "latency", buckets=(0.01, 0.1, 1.0),
                  verb="PATCH").observe(0.2)
    return reg, hist


@pytest.mark.parametrize("name,labels", [
    ("tpuctl_requests_total", {}),
    ("tpuctl_requests_total", {"code": "200"}),
    ("tpuctl_requests_total", {"code": "503", "verb": "GET"}),
    ("tpuctl_requests_total", {"code": "404"}),
    ("tpu_serving_queue_depth", {}),
    ("tpu_serving_queue_depth", {"job": "b"}),
    ("tpuctl_request_duration_seconds", {}),
    ("tpuctl_request_duration_seconds", {"verb": "GET"}),
    ("absent_family_total", {}),
])
def test_registry_total_equals_the_reference(name, labels):
    got = []
    for tel in (ref_telemetry, telemetry):
        reg, _ = _observed_registry(tel)
        got.append(reg.total(name, **labels))
        # an absent family reads 0.0 and is not created by the read
        assert "absent_family_total" not in reg.render()
    assert got[1] == got[0]


def test_registry_family_types_and_cumulative_equal_the_reference():
    (ref_reg, ref_hist), (reg, hist) = (_observed_registry(tel)
                                        for tel in (ref_telemetry,
                                                    telemetry))
    assert reg.family_types() == ref_reg.family_types() == {
        "tpuctl_requests_total": "counter",
        "tpu_serving_queue_depth": "gauge",
        "tpuctl_request_duration_seconds": "histogram"}
    assert hist.cumulative() == ref_hist.cumulative() == [1, 3, 4, 5]
    assert telemetry.MetricsRegistry().family_types() == {}


def test_operator_trace_events_equal_the_reference():
    assert telemetry.OPERATOR_TRACE_EVENTS == \
        ref_telemetry.OPERATOR_TRACE_EVENTS
