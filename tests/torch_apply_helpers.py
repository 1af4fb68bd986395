"""Shared pieces of the port's apply-path and fleet-controller tests
(``test_torch_kubeapply``, ``test_torch_telemetry``, ``test_torch_events``,
``test_torch_admission``, ``test_torch_maintenance``,
``test_torch_autoscale``, and the observability and contract tools'
tests): the wire recorder, the fleet helpers below, the port's CLI in a
subprocess (:func:`run_port_cli`), and a fixture that turns Nagle's
algorithm off on the fake apiserver's
connections. The fake writes a reply's headers and body in two sends;
with Nagle on, the body waits for the client's delayed ACK (about 40 ms
a request on some kernels). Turning it off changes no byte on the
wire."""

import http.client
import json
import os
import re
import socketserver
import subprocess
import sys

import pytest

_TRACEPARENT = re.compile(r"00-[0-9a-f]{32}-[0-9a-f]{16}-01")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def run_port_cli(*argv, block_yaml=True, timeout=60):
    """``python -m tpu_cluster_torch ARGV`` in a subprocess from the repo
    root, with PyYAML made unimportable unless ``block_yaml`` is False
    (the observability and lint commands must not need it)."""
    code = ("import runpy, sys\n"
            + ("sys.modules['yaml'] = None\n" if block_yaml else "")
            + "runpy.run_module('tpu_cluster_torch', run_name='__main__', "
              "alter_sys=True)\n")
    return subprocess.run([sys.executable, "-c", code, *map(str, argv)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(autouse=True)
def no_nagle(monkeypatch):
    monkeypatch.setattr(socketserver.StreamRequestHandler,
                        "disable_nagle_algorithm", True)


def mask_traceparents(text):
    return _TRACEPARENT.sub("TRACEPARENT", text)


class Wire:
    """Every request a client sends through ``http.client`` (both engines'
    default keep-alive transport): method, URL, body with W3C traceparent
    ids masked, Content-Type.

    No lock: ``list.append`` is atomic, and the suite's lock-order monitor
    would see a lock taken here under the client's SSA probe lock as a
    new edge. ``take`` runs once the client is closed."""

    def __init__(self, monkeypatch):
        self._log = []
        orig = http.client.HTTPConnection.request
        log = self._log

        def request(conn, method, url, body=None, headers=None, **kw):
            text = body.decode() if isinstance(body, bytes) else body or ""
            ctype = (headers or {}).get("Content-Type", "")
            log.append((method, url, mask_traceparents(text), ctype))
            return orig(conn, method, url, body=body, headers=headers or {},
                        **kw)

        monkeypatch.setattr(http.client.HTTPConnection, "request", request)

    def take(self):
        out = list(self._log)
        del self._log[:]
        return out


# ------------------------------------------------------------------ fleet
# Shared by the fleet-controller tests (``test_torch_admission``,
# ``test_torch_maintenance``, ``test_torch_autoscale``): both packages
# side by side, the gang model's type map and the reference-to-port text
# map their comparisons go through.

_ISO = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ")
_NAME_CLOCK = re.compile(r"\.(\d{6})\.[0-9a-f]{6}")


def mask_clock(text):
    """Timestamps, the time suffix of an Event's name and traceparents
    masked: what is made of the clock or of random ids."""
    return _NAME_CLOCK.sub(r".\1.CLOCK",
                           _ISO.sub("TIMESTAMP", mask_traceparents(text)))


def packages():
    """(reference, port): each a namespace of the fleet modules."""
    from types import SimpleNamespace

    from tpu_cluster import (admission, autoscale, events, informer,
                             kubeapply, maintenance, metricsdb, telemetry)
    import tpu_cluster_torch.admission as p_admission
    import tpu_cluster_torch.autoscale as p_autoscale
    import tpu_cluster_torch.events as p_events
    import tpu_cluster_torch.informer as p_informer
    import tpu_cluster_torch.kubeapply as p_kubeapply
    import tpu_cluster_torch.maintenance as p_maintenance
    import tpu_cluster_torch.metricsdb as p_metricsdb
    import tpu_cluster_torch.telemetry as p_telemetry

    ref = SimpleNamespace(
        name="reference", admission=admission, autoscale=autoscale,
        events=events, informer=informer, kubeapply=kubeapply,
        maintenance=maintenance, metricsdb=metricsdb, telemetry=telemetry)
    port = SimpleNamespace(
        name="port", admission=p_admission, autoscale=p_autoscale,
        events=p_events, informer=p_informer, kubeapply=p_kubeapply,
        maintenance=p_maintenance, metricsdb=p_metricsdb,
        telemetry=p_telemetry)
    return ref, port


# The gang model on a GPU host: a reference slice type is a host layout
# and a host count (the gang Job's completions); a reference per-host
# type is a layout.
TYPE_MAP = {
    "v5e-8": ("h100-sxm5-80gb-8", 1),
    "v5e-16": ("h100-sxm5-80gb-8", 2),
    "v5e-32": ("h100-sxm5-80gb-8", 4),
    "v5p-8": ("h100-sxm5-80gb-1", 1),
}
# reference ConfigMap, event-component and resource names -> the port's
# (longest first: the state ConfigMaps before the components they start
# with)
_NAME_MAP = (
    ("tpu-gang-reservations", "gpu-gang-reservations"),
    ("tpu-maintenance-state", "gpu-maintenance-state"),
    ("tpu-autoscale-state", "gpu-autoscale-state"),
    ("tpu-admission", "gpu-admission"),
    ("tpu-maintenance", "gpu-maintenance"),
    ("tpu-autoscale", "gpu-autoscale"),
    # the gang helper's Job
    ("google.com/tpu", "nvidia.com/gpu"),
    ("tpu-stack/worker:v1", "gpu-stack/worker:v1"),
)
_WAIT_REASON = re.compile(r"(\d+) x (\d+)-chip host\(s\) for (v5[ep]-\d+)")
_TYPE_NAME = re.compile(r"\bv5[ep]-\d+\b")


def cards_of(layout):
    from tpu_cluster_torch import topology

    return topology.get_host(layout).cards_per_host


def to_port(text):
    """A reference text (wire body, reason, CLI output) in the port's
    names: ConfigMaps and components, "N x C-chip host(s) for <type>"
    as "N x C'-card host(s) for <layout>", then every type name as its
    layout."""
    for old, new in _NAME_MAP:
        text = text.replace(old, new)

    def wait(m):
        layout, hosts = TYPE_MAP[m.group(3)]
        assert int(m.group(1)) == hosts, m.group(0)
        return f"{hosts} x {cards_of(layout)}-card host(s) for {layout}"

    text = _WAIT_REASON.sub(wait, text)
    return _TYPE_NAME.sub(lambda m: TYPE_MAP[m.group(0)][0], text)


def seed_hosts(pkg, client, names, host_type="v5e-8", ready=True):
    """Nodes of the reference per-host type ``host_type`` (the port: its
    layout), as each package's ``node_manifest`` publishes them."""
    acc = host_type if pkg.name == "reference" else TYPE_MAP[host_type][0]
    for n in names:
        client.apply(pkg.admission.node_manifest(n, acc, ready=ready))


def gang_job(pkg, gang, ref_type="v5e-16", namespace="gpu-system",
             priority=0, job_name=""):
    """The gang Job of reference type ``ref_type`` (the port: its layout
    and host count)."""
    if pkg.name == "reference":
        return pkg.admission.gang_job_manifest(
            gang, ref_type, namespace, priority=priority, job_name=job_name)
    layout, hosts = TYPE_MAP[ref_type]
    return pkg.admission.gang_job_manifest(
        gang, layout, namespace, priority=priority, job_name=job_name,
        hosts=hosts)


def controller_store(api):
    """What the controllers write, from a fake's store: every ConfigMap's
    data, every Job's annotations, every Node's maintenance fields, and
    every Event (reason, type, count, message, object, component), with
    the clock masked. Events are a sorted list: fresh recorders name
    theirs alike but for the clock, so masked names may repeat."""
    out = {}
    events = []
    for path, obj in sorted(api.snapshot().items()):
        meta = obj.get("metadata") or {}
        if "/configmaps/" in path:
            out[path] = obj.get("data")
        elif "/jobs/" in path:
            out[path] = meta.get("annotations")
        elif path.startswith("/api/v1/nodes/"):
            out[path] = {
                "unschedulable": (obj.get("spec") or {}).get("unschedulable"),
                "annotations": meta.get("annotations"),
                "version": (meta.get("labels") or {}).get(
                    "tpu-stack.dev/stack-version")}
        elif "/events/" in path:
            inv = obj.get("involvedObject") or {}
            events.append({
                "name": mask_clock(path),
                "reason": obj.get("reason"), "type": obj.get("type"),
                "count": obj.get("count"), "message": obj.get("message"),
                "object": [inv.get("kind"), inv.get("name")],
                "component": (obj.get("source") or {}).get("component")})
    out["events"] = sorted(events, key=lambda e: json.dumps(e,
                                                            sort_keys=True))
    return json.loads(mask_clock(json.dumps(out, sort_keys=True)))
