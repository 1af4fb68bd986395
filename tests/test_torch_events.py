"""The port's Events pipeline (``tpu_cluster_torch.events``) against the
reference's: ``apply --events`` posts the same Events.

Both engines apply the port's operand groups with an ``EventRecorder``
(and telemetry, so each Event carries the rollout's traceparent) against
a fake apiserver running the same fault script. Compared exactly after
masking what is made of the clock or of random ids (timestamps, the
time suffix of an Event's name, traceparents): every request on the
wire, the Events stored, the error raised. Then the CLI: ``apply
--events`` leaves a Retrying Event that ``events`` lists, filters and
joins with the rollout's trace.
"""

import io
import json
import re
from contextlib import redirect_stdout

import pytest

from fake_apiserver import FakeApiServer
from torch_apply_helpers import Wire, mask_traceparents, no_nagle  # noqa: F401
from tpu_cluster import events as ref_events
from tpu_cluster import kubeapply as ref_kubeapply
from tpu_cluster import telemetry as ref_telemetry
from tpu_cluster_torch import __main__ as cli
from tpu_cluster_torch import events, kubeapply, telemetry
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch.render import manifests

ENGINES = (("reference", ref_kubeapply, ref_events, ref_telemetry),
           ("port", kubeapply, events, telemetry))
NS = "gpu-system"
_ISO = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ")
_NAME_CLOCK = re.compile(r"\.(\d{6})\.[0-9a-f]{6}")


def mask(text):
    return _NAME_CLOCK.sub(r".\1.CLOCK",
                           _ISO.sub("TIMESTAMP", mask_traceparents(text)))


@pytest.fixture(scope="module")
def groups():
    return manifests.rollout_groups(specmod.default_spec())


def stored_events(api):
    return [api.get(p) for p in sorted(api.paths("/events/"))]


SCRIPTS = {
    # a burst on the Namespace's apply: one Retrying Event, count 3
    "retrying": [{"status": 503, "count": 3, "retry_after": 0.01,
                  "method": "PATCH", "match": f"/api/v1/namespaces/{NS}",
                  "exact": True}],
    # the device plugin's apply never succeeds: Retrying, then
    # RetryExhausted, and the rollout fails
    "exhausted": [{"status": 503, "count": 10, "method": "PATCH",
                   "match": "daemonsets/gpu-device-plugin"}],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_apply_with_events_posts_the_same_events(monkeypatch, groups,
                                                 script):
    wire = Wire(monkeypatch)
    out = {}
    for name, kmod, emod, tmod in ENGINES:
        tel = tmod.Telemetry()
        with FakeApiServer(auto_ready=True, chaos=SCRIPTS[script]) as api:
            client = kmod.Client(api.url, telemetry=tel,
                                 retry=kmod.RetryPolicy(attempts=5,
                                                        base_s=0.01,
                                                        cap_s=0.02))
            client.events = emod.EventRecorder(client, component="tpuctl",
                                               telemetry=tel)
            try:
                kmod.apply_groups(client, groups, wait=True,
                                  stage_timeout=10, poll=0.02)
                error = None
            except kmod.ApplyError as exc:
                error = type(exc).__name__
            finally:
                client.close()
            out[name] = {
                "wire": [(m, mask(u), mask(b), c)
                         for m, u, b, c in wire.take()],
                "events": json.loads(mask(json.dumps(stored_events(api)))),
                "error": error, "counts": client.events.counts()}
            if name == "port":
                annotated = stored_events(api)
                trace_id = tel.tracer.trace_id
    assert out["port"] == out["reference"]
    reasons = [e["reason"] for e in out["port"]["events"]]
    if script == "retrying":
        assert reasons == ["Retrying"] and out["port"]["error"] is None
        assert out["port"]["events"][0]["count"] == 3
    else:
        assert reasons.count("RetryExhausted") == 1
        assert out["port"]["error"] == "ApplyError"
    for ev in annotated:
        header = ev["metadata"]["annotations"][
            telemetry.TRACEPARENT_ANNOTATION]
        assert telemetry.parse_traceparent(header)[0] == trace_id


def test_collection_ref_and_path_ref_agree():
    for path in ("/api/v1/namespaces/gpu-system/configmaps/x",
                 "/apis/apps/v1/namespaces/gpu-system/daemonsets/d",
                 "/api/v1/nodes/n1", "/api/v1/nodes",
                 "/apis/tpu-stack.dev/v1alpha1/tpustackpolicies/default"):
        assert events.path_ref(path) == ref_events.path_ref(path)
    for coll in ("/api/v1/nodes", "/apis/batch/v1/namespaces/gpu-system/jobs"):
        assert events.collection_ref(coll) == ref_events.collection_ref(coll)
    ev = {"lastTimestamp": "2026-01-01T00:00:00Z", "type": "Warning",
          "reason": "RetryExhausted", "count": 2, "message": "gave up",
          "involvedObject": {"kind": "DaemonSet", "name": "gpu-x"}}
    assert events.format_event_row(ev, "ab" * 16) == \
        ref_events.format_event_row(ev, "ab" * 16)
    assert events.EVENT_HEADER == ref_events.EVENT_HEADER


def test_recorder_fails_open():
    """Every Event write refused: the rollout converges all the same and
    only the failure counter moves."""
    chaos = [{"status": 403, "method": "POST", "match": "/events"}]
    tel = telemetry.Telemetry()
    with FakeApiServer(auto_ready=True, chaos=chaos) as api:
        client = kubeapply.Client(api.url)
        client.events = events.EventRecorder(client, telemetry=tel)
        cm = {"apiVersion": "v1", "kind": "ConfigMap",
              "metadata": {"name": "ev", "namespace": NS}}
        client.events.emit(cm, "Drive", "one")
        client.close()
        assert stored_events(api) == []
    assert client.events.counts()["failures"] == 1
    assert f"{telemetry.EVENT_EMIT_FAILURES_TOTAL} 1" in \
        tel.metrics.render().splitlines()


def run_main(*argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, buf.getvalue()


def test_cli_apply_events_then_events_lists_and_joins(tmp_path, capsys):
    chaos = SCRIPTS["retrying"]
    trace = tmp_path / "t.json"
    with FakeApiServer(auto_ready=True, chaos=chaos) as api:
        rc, out = run_main("apply", "--apiserver", api.url, "--events",
                           "--poll", "0.02", "--retry-base", "0.01",
                           "--flight-recorder", "off",
                           "--trace-out", str(trace))
        assert rc == 0, out
        trace_id = json.loads(trace.read_text())["otherData"]["trace_id"]
        rc, out = run_main("events", "--apiserver", api.url)
        assert rc == 0
        assert out.splitlines()[0] == events.EVENT_HEADER
        assert "Retrying" in out and f"Namespace/{NS}" in out
        assert trace_id[:16] in out
        rc, out = run_main("events", "--apiserver", api.url, "--for",
                           f"Namespace/{NS}", "--json")
        doc = json.loads(out)
        assert [e["reason"] for e in doc["events"]] == ["Retrying"]
        assert doc["events"][0]["trace"] == trace_id
        rc, out = run_main("events", "--apiserver", api.url, "--for",
                           "Job/absent", "--json")
        assert json.loads(out)["events"] == []
        rc, out = run_main("events", "--apiserver", api.url, "--follow",
                           "--follow-seconds", "0.3")
        assert rc == 0 and "Retrying" in out
    assert cli.main(["events"]) == 2
    assert "--apiserver URL required" in capsys.readouterr().err
