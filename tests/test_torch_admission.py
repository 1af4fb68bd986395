"""The port's gang admission (``tpu_cluster_torch.admission``) against the
reference's (``tpu_cluster/admission.py``) under the gang model's type
map: a reference slice type is a host layout and a host count (the gang
Job's ``completions``), a reference per-host type is a layout
(``torch_apply_helpers.TYPE_MAP``: v5e-8, v5e-16, v5e-32 on eight-card
hosts; v5p-8, another per-host shape, on one-card hosts).

What is compared, exactly unless a test says otherwise, once the
reference's names are mapped to the port's (``to_port``):
- ``arbitrate`` on the same scenarios: admitted gangs, their hosts,
  every decision and reason; reserved card indices are the layout's
  (``0..cards_per_host-1``);
- ``check_allocation`` verdicts and reasons on the reference's verdict
  vectors, and ``build_table``/``parse_table`` JSON byte for byte;
- both controllers against two fake apiservers, polling and
  watch-driven: the wire (every request, bodies with the clock and
  traceparents masked; a multiset where informer threads race the
  controller), the pass lines, and what the controllers wrote to the
  store (ConfigMaps, Job annotations, Events);
- the CLI's ``queue`` and ``admission --once``.
No wait here is longer than the fake's own settling.
"""

import io
import itertools
import json
import os
import re
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from fake_apiserver import FakeApiServer
from torch_apply_helpers import (TYPE_MAP, Wire, cards_of,  # noqa: F401
                                 controller_store, gang_job, mask_clock,
                                 no_nagle, packages, seed_hosts, to_port)
from tpu_cluster import __main__ as ref_cli
from tpu_cluster_torch import __main__ as cli
from tpu_cluster_torch import topology

REF, PORT = packages()
PACKAGES = (REF, PORT)
NS = "gpu-system"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cm_path(pkg):
    return (f"/api/v1/namespaces/{NS}/configmaps/"
            f"{pkg.admission.RESERVATION_CONFIGMAP}")


def published_table(pkg, api):
    cm = api.get(_cm_path(pkg))
    if cm is None:
        return None
    raw = (cm.get("data") or {}).get(pkg.admission.RESERVATION_KEY) or ""
    return pkg.admission.parse_table(json.loads(raw))


# ------------------------------------------------------------ the model


def test_constants_keep_the_reference_contract_and_take_gpu_names():
    ref, port = REF.admission, PORT.admission
    for name in ("RESERVATION_KEY", "RESERVATION_SCHEMA_VERSION",
                 "GANG_ANNOTATION", "GANG_ACCELERATOR_ANNOTATION",
                 "GANG_PRIORITY_ANNOTATION", "GANG_STATUS_ANNOTATION",
                 "GANG_REASON_ANNOTATION", "MAINTENANCE_ANNOTATION",
                 "EVENT_ADMITTED", "EVENT_READMITTED", "EVENT_PREEMPTED",
                 "EVENT_DRAINED", "DRAIN_REASON_PREFIX", "NODES_PATH",
                 "STATUS_ADMITTED", "STATUS_QUEUED", "STATUS_PREEMPTED"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.RESERVATION_CONFIGMAP == "gpu-gang-reservations"
    from tpu_cluster_torch.discovery import labels
    assert (port.PRODUCT_LABEL, port.TOPOLOGY_LABEL, port.GPU_RESOURCE) \
        == (labels.PRODUCT, labels.TOPOLOGY, "nvidia.com/gpu")


@pytest.mark.parametrize("ref_type", sorted(TYPE_MAP))
def test_gang_job_and_node_read_back_under_the_type_map(ref_type):
    """gang_of_job reads the layout and the host count (completions) the
    port's gang Job declares; host_capacity reads a Node of the layout
    as that layout with its card count."""
    ref_job = gang_job(REF, "g", ref_type, priority=3)
    port_job = gang_job(PORT, "g", ref_type, priority=3)
    layout, hosts = TYPE_MAP[ref_type]
    g = PORT.admission.gang_of_job(port_job)
    want = REF.admission.gang_of_job(ref_job)
    assert (g.name, g.job_name, g.priority, g.job_path) == \
        (want.name, want.job_name, want.priority, want.job_path)
    assert (g.accelerator, g.hosts) == (layout, hosts)
    assert port_job["spec"]["completions"] == \
        port_job["spec"]["parallelism"] == hosts
    req = port_job["spec"]["template"]["spec"]["containers"][0][
        "resources"]["requests"]
    assert req == {"nvidia.com/gpu": str(cards_of(layout))}
    host = PORT.admission.host_capacity(
        PORT.admission.node_manifest("n1", layout))
    assert (host.accelerator, host.cards, host.ready, host.cordoned) == \
        (layout, cards_of(layout), True, False)
    assert PORT.admission._host_matches(host, topology.get_host(layout))


def test_the_rendered_multihost_jobs_are_gangs_that_lint_accepts():
    """The port's multi-host validation Jobs carry the gang annotations
    of their layout, read back with the Job's host count, and the
    gang helper's Job passes lint R07 as the rendered ones do."""
    from tpu_cluster_torch import lint, spec as specmod
    from tpu_cluster_torch.render import jobs
    spec = specmod.default_spec()
    objs = jobs.render_validation_jobs(spec.gpu, multihost_hosts=3)
    gangs = [PORT.admission.gang_of_job(o) for o in objs
             if o["kind"] == "Job"]
    assert [(g.name, g.accelerator, g.hosts) for g in gangs if g] == [
        ("gpu-psum-multihost", "h100-sxm5-80gb-8", 3),
        ("gpu-burnin-multihost", "h100-sxm5-80gb-8", 3)]
    for o in objs:
        if o["kind"] == "Job" and "multihost" not in o["metadata"]["name"]:
            assert PORT.admission.gang_of_job(o) is None
    extra = PORT.admission.gang_job_manifest(
        "extra", "h100-sxm5-80gb-8", NS, hosts=4)
    findings = lint.lint_groups([objs + [extra]], spec)
    assert [f for f in findings if f.rule == "R07"] == []


# ------------------------------------------------------------ arbitrate


def _hosts(pkg, specs):
    """specs: (name, reference per-host type, ready, cordon group)."""
    out = []
    for name, host_type, ready, group in specs:
        acc = host_type if pkg is REF else TYPE_MAP[host_type][0]
        node = pkg.admission.node_manifest(name, acc, ready=ready)
        if group:
            node["spec"] = {"unschedulable": True}
            node["metadata"]["annotations"] = {
                pkg.admission.MAINTENANCE_ANNOTATION: group}
        out.append(pkg.admission.host_capacity(node))
    return out


def _gangs(pkg, specs):
    """specs: (gang, reference type, priority)."""
    out = []
    for gang, ref_type, prio in specs:
        if ref_type in TYPE_MAP:
            job = gang_job(pkg, gang, ref_type, priority=prio)
        else:  # a type neither catalogue knows
            job = gang_job(pkg, gang, "v5e-8", priority=prio)
            job["metadata"]["annotations"][
                pkg.admission.GANG_ACCELERATOR_ANNOTATION] = ref_type
        out.append(pkg.admission.gang_of_job(job))
    return out


def _previous(pkg, specs):
    """specs: {gang: (reference type, priority, [hosts])}."""
    out = {}
    for gang, (ref_type, prio, hosts) in specs.items():
        if pkg is REF:
            acc = REF.admission.topology.get(ref_type)
            acc_name, cards = acc.name, acc.chips_per_host
        else:
            acc_name = TYPE_MAP[ref_type][0]
            cards = cards_of(acc_name)
        out[gang] = pkg.admission.Reservation(
            gang=gang, accelerator=acc_name, priority=prio,
            hosts=tuple((h, tuple(range(cards))) for h in sorted(hosts)))
    return out


def _outcome(pkg, arb):
    admitted = {}
    for name, res in arb.admitted.items():
        admitted[name] = {"accelerator": res.accelerator,
                          "priority": res.priority,
                          "hosts": [h for h, _ in res.hosts],
                          "cards": sorted({len(ids) for _, ids in res.hosts})}
    decisions = {n: [d.status, d.reason] for n, d in arb.decisions.items()}
    return {"admitted": admitted, "decisions": decisions}


def _ref_expected(out):
    """The reference's outcome in the port's terms: names mapped, each
    reservation's card count the layout's."""
    doc = json.loads(to_port(json.dumps(out, sort_keys=True)))
    for res in doc["admitted"].values():
        res["cards"] = [cards_of(res["accelerator"])]
    return doc


A, B, C, D = "node-a", "node-b", "node-c", "node-d"
SCENARIOS = {
    # two 2-host gangs race for two hosts: the first to arrive wins
    "fifo": dict(
        hosts=[(A, "v5e-8", True, ""), (B, "v5e-8", True, "")],
        gangs=[("alpha", "v5e-16", 0), ("beta", "v5e-16", 0)],
        previous={}, arrival={"alpha": 1.0, "beta": 2.0}),
    # a 4-host gang over three hosts holds nothing
    "all_or_nothing": dict(
        hosts=[(h, "v5e-8", True, "") for h in (A, B, C)],
        gangs=[("big", "v5e-32", 0)], previous={}, arrival={"big": 1.0}),
    # a newcomer of higher priority takes the lowest holder's hosts only
    "priority_preemption": dict(
        hosts=[(h, "v5e-8", True, "") for h in (A, B, C, D)],
        gangs=[("mid", "v5e-16", 1), ("low", "v5e-16", 0),
               ("vip", "v5e-16", 5)],
        previous={"mid": ("v5e-16", 1, [C, D]),
                  "low": ("v5e-16", 0, [A, B])},
        arrival={"mid": 1.0, "low": 2.0, "vip": 3.0}),
    # an admitted gang keeps its exact hosts though others sort first
    "stickiness": dict(
        hosts=[(h, "v5e-8", True, "") for h in (A, B, C, D)],
        gangs=[("held", "v5e-16", 0), ("new", "v5e-16", 0)],
        previous={"held": ("v5e-16", 0, [C, D])},
        arrival={"held": 1.0, "new": 2.0}),
    # a NotReady host is no seat: its gang re-queues whole
    "not_ready_drain": dict(
        hosts=[(A, "v5e-8", True, ""), (B, "v5e-8", False, ""),
               (C, "v5e-8", True, "")],
        gangs=[("train", "v5e-16", 0)],
        previous={"train": ("v5e-16", 0, [A, B])},
        arrival={"train": 1.0}),
    # a cordoned host is no seat, and the reason names its wave group
    "cordon": dict(
        hosts=[(A, "v5e-8", True, "g/7"), (B, "v5e-8", True, "")],
        gangs=[("waiter", "v5e-16", 0), ("solo", "v5e-8", 0)],
        previous={}, arrival={"waiter": 1.0, "solo": 2.0}),
    # two Jobs naming one gang: the first request wins
    "duplicate_gang": dict(
        hosts=[(A, "v5e-8", True, ""), (B, "v5e-8", True, "")],
        gangs=[("dup", "v5e-8", 0), ("dup", "v5e-16", 0)],
        previous={}, arrival={"dup": 1.0}),
    # a type no catalogue knows queues with the reference's reason
    "unknown_type": dict(
        hosts=[(A, "v5e-8", True, "")],
        gangs=[("odd", "v9x-64", 0), ("fine", "v5e-8", 0)],
        previous={}, arrival={"odd": 1.0, "fine": 2.0}),
    # hosts of two per-host shapes: each gang seats only on its own
    "two_shapes": dict(
        hosts=[(A, "v5e-8", True, ""), (B, "v5p-8", True, ""),
               (C, "v5p-8", True, "")],
        gangs=[("e", "v5e-8", 0), ("p", "v5p-8", 0), ("p2", "v5p-8", 0),
               ("p3", "v5p-8", 0)],
        previous={}, arrival={"e": 1.0, "p": 2.0, "p2": 3.0, "p3": 4.0}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_arbitrate_gives_the_reference_verdicts(scenario):
    sc = SCENARIOS[scenario]
    out = {}
    for pkg in PACKAGES:
        arb = pkg.admission.arbitrate(
            _hosts(pkg, sc["hosts"]), _gangs(pkg, sc["gangs"]),
            _previous(pkg, sc["previous"]), sc["arrival"])
        out[pkg.name] = _outcome(pkg, arb)
    assert out["port"] == _ref_expected(out["reference"])
    assert out["port"]["decisions"], "the scenario decided nothing"


# ----------------------------------------------- verdicts and the table


def _vectors():
    from test_admission import _selftest_vectors
    return _selftest_vectors()


def test_check_allocation_on_the_reference_verdict_vectors():
    table_json, cases = _vectors()
    tables = {pkg.name: pkg.admission.parse_table(json.loads(table_json))
              for pkg in PACKAGES}
    for host, ids, want_ok, want_gang in cases:
        ref = REF.admission.check_allocation(tables["reference"], host, ids)
        port = PORT.admission.check_allocation(tables["port"], host, ids)
        assert port == ref, (host, ids)
        assert port[0] == want_ok and (not want_ok or port[1] == want_gang)


def test_no_partial_allocate_on_either_side():
    doc = {"version": 1, "cordoned": ["h9"],
           "gangs": {"g": {"accelerator": "h100-sxm5-80gb-8", "priority": 0,
                           "hosts": {"h1": list(range(8)),
                                     "h2": list(range(8))}}}}
    tables = [pkg.admission.parse_table(doc) for pkg in PACKAGES]
    probes = [(h, list(c)) for h in ("h1", "h2", "h3", "h9")
              for k in (0, 1, 4, 7, 8)
              for c in itertools.islice(itertools.combinations(range(8), k),
                                        6)]
    probes += [("h1", [0, 0, 1]), ("h1", list(range(9)))]
    for host, ids in probes:
        verdicts = [pkg.admission.check_allocation(t, host, ids)
                    for pkg, t in zip(PACKAGES, tables)]
        assert verdicts[1] == verdicts[0], (host, ids)
        if verdicts[1][0]:
            assert (host, sorted(ids)) in (("h1", list(range(8))),
                                           ("h2", list(range(8))))


def test_build_and_parse_table_are_byte_identical():
    table_json, _cases = _vectors()
    docs = [table_json,
            json.dumps({"version": 1, "cordoned": ["z", "a", "a"],
                        "gangs": {"b": {"accelerator": "h100-sxm5-80gb-1",
                                        "priority": 2,
                                        "hosts": {"n2": [0], "n1": [0]}},
                                  "a": {"accelerator": "h100-sxm5-80gb-8",
                                        "hosts": {"n3": [7, 1, 0]}}}})]
    for raw in docs:
        texts = []
        for pkg in PACKAGES:
            table = pkg.admission.parse_table(json.loads(raw))
            texts.append(json.dumps(pkg.admission.build_table(table),
                                    sort_keys=True, separators=(",", ":")))
        assert texts[1] == texts[0]
    for bad in ({"version": 2, "gangs": {}},
                {"version": 1, "gangs": {"g": {"hosts": {"h": ["x"]}}}},
                {"version": 1, "cordoned": "h1"}):
        for pkg in PACKAGES:
            with pytest.raises(ValueError):
                pkg.admission.parse_table(bad)


# ------------------------------------------------------- the controllers


def _run_both(monkeypatch, drive, server_kw=None):
    """``drive(pkg, client, api)`` once per package against a fresh fake
    (nothing recorded before ``drive`` calls ``wire.take()``); returns
    {package: (drive's result, wire, server log, controller store)}."""
    wire = Wire(monkeypatch)
    out = {}
    for pkg in PACKAGES:
        with FakeApiServer(auto_ready=True, **(server_kw or {})) as api:
            client = pkg.kubeapply.Client(
                api.url, retry=pkg.kubeapply.RetryPolicy(
                    attempts=5, base_s=0.01, cap_s=0.05))
            try:
                result = drive(pkg, client, api, wire)
            finally:
                client.close()
            out[pkg.name] = (result, wire.take(), list(api.log),
                             controller_store(api))
    return out


def _mask_wire(records):
    return [(m, u, mask_clock(body), ct) for m, u, body, ct in records]


def _assert_same(out, multiset=False):
    ref, port = out["reference"], out["port"]
    ref_mapped = json.loads(to_port(json.dumps(
        [ref[0], _mask_wire(ref[1]), ref[2], ref[3]])))
    got = json.loads(json.dumps(
        [port[0], _mask_wire(port[1]), port[2], port[3]]))
    if multiset:
        for i in (1, 2):
            ref_mapped[i] = sorted(map(json.dumps, ref_mapped[i]))
            got[i] = sorted(map(json.dumps, got[i]))
    assert got[0] == ref_mapped[0]
    assert got[3] == ref_mapped[3]
    assert got[2] == ref_mapped[2]
    assert got[1] == ref_mapped[1]


def test_polling_controller_transitions_and_events(monkeypatch):
    """The reference's transition story on one gang -- Admitted,
    Preempted, ReAdmitted, Drained, ReAdmitted -- with a preemptor that
    comes and goes: equal pass lines, wire, store and Events."""
    def drive(pkg, client, api, wire):
        seed_hosts(pkg, client, (A, B))
        client.apply(gang_job(pkg, "low", "v5e-16"))
        wire.take()
        tel = pkg.telemetry.Telemetry()
        rec = pkg.events.EventRecorder(
            client, component=pkg.name == "port" and "gpu-admission"
            or "tpu-admission")
        ctrl = pkg.admission.AdmissionController(client, NS, telemetry=tel,
                                                 events=rec)
        lines = [ctrl.step().line(), ctrl.step().line()]
        client.apply(gang_job(pkg, "high", "v5e-16", priority=9))
        lines.append(ctrl.step().line())
        client.delete(f"/apis/batch/v1/namespaces/{NS}/jobs/gang-high")
        lines.append(ctrl.step().line())
        api.set_node_ready(B, ready=False)
        lines += [ctrl.step().line(), ctrl.step().line()]
        api.set_node_ready(B, ready=True)
        lines.append(ctrl.step().line())
        metrics = sorted(line for line in tel.metrics.render().splitlines()
                         if line.startswith(("tpuctl_admissions_total",
                                             "tpuctl_preemptions_total",
                                             "tpuctl_gang_wait_seconds_count")))
        return {"lines": lines, "metrics": metrics,
                "counts": rec.counts()}

    out = _run_both(monkeypatch, drive)
    _assert_same(out)
    events = [e["reason"] for e in out["port"][3]["events"]]
    assert sorted(events) == sorted(["Admitted", "Admitted", "Preempted",
                                     "ReAdmitted", "Drained", "ReAdmitted"])


def test_cordons_compose_with_failure_drains(monkeypatch):
    """Cordoned hosts are no seat and the queue reason names the group;
    the published table carries the cordon; a maintenance drain whose
    host then goes NotReady tells one story; a fresh controller each
    pass recovers the event memo from the annotations."""
    def drive(pkg, client, api, wire):
        seed_hosts(pkg, client, (A, B, C))
        client.patch_merge(f"/api/v1/nodes/{C}", {
            "spec": {"unschedulable": True},
            "metadata": {"annotations": {
                pkg.admission.MAINTENANCE_ANNOTATION: "g/7"}}})
        client.apply(gang_job(pkg, "compose", "v5e-16"))
        client.apply(gang_job(pkg, "waiter", "v5e-8"))
        wire.take()
        component = "gpu-admission" if pkg.name == "port" else \
            "tpu-admission"
        lines, reasons = [], []

        def fresh_pass():
            rec = pkg.events.EventRecorder(client, component=component)
            ctrl = pkg.admission.AdmissionController(client, NS,
                                                     events=rec)
            lines.append(ctrl.step().line())
            reasons.append({n: [d.status, d.reason] for n, d in
                            ctrl.decisions_snapshot().items()})

        fresh_pass()
        client.patch_merge(f"/api/v1/nodes/{B}", {
            "spec": {"unschedulable": True},
            "metadata": {"annotations": {
                pkg.admission.MAINTENANCE_ANNOTATION: "g/1"}}})
        fresh_pass()
        api.set_node_ready(B, ready=False)
        fresh_pass()
        api.set_node_ready(B, ready=True)
        for node in (B, C):
            client.patch_merge(f"/api/v1/nodes/{node}", {
                "spec": {"unschedulable": False},
                "metadata": {"annotations": {
                    pkg.admission.MAINTENANCE_ANNOTATION: None}}})
        fresh_pass()
        fresh_pass()
        table = published_table(pkg, api)
        return {"lines": lines, "reasons": reasons,
                "cordoned": list(table.cordoned)}

    out = _run_both(monkeypatch, drive)
    _assert_same(out)
    assert any("waiting on cordoned host group g/7" in r[1]
               for r in out["port"][0]["reasons"][0].values())


def _settle(informers, before, timeout=5.0):
    """Wait until every informer's sequence moved past ``before``."""
    deadline = time.monotonic() + timeout
    for path, seq in before.items():
        informers.informers[path].wait_event(
            seq, max(0.0, deadline - time.monotonic()))


def _seqs(informers):
    return {p: inf.seq() for p, inf in informers.informers.items()}


def test_watch_driven_controller_reads_only_its_informers(monkeypatch):
    """Watch-driven: after the paginated sync a pass reads nothing; the
    race, a NotReady drain and the recovery go through the informer
    caches. The informers' threads race the controller on the wire, so
    wire and server log are compared as multisets, without the watch
    opens (a window may end, and its re-open land, at any time) and with
    the continue tokens of the paginated sync masked."""
    def drive(pkg, client, api, wire):
        seed_hosts(pkg, client, (A, B))
        client.apply(gang_job(pkg, "alpha", "v5e-16"))
        client.apply(gang_job(pkg, "beta", "v5e-16"))
        wire.take()
        ctrl = pkg.admission.AdmissionController(client, NS)
        # a one-second watch window: stop() returns when the window
        # ends (the stream's socket is the response's, which stop()
        # cannot reach), in both packages
        informers = ctrl.build_informers(page_limit=1, window_s=1)
        informers.start()
        try:
            assert informers.wait_synced(10)
            lines = []
            jobs_path = f"/apis/batch/v1/namespaces/{NS}/jobs"
            before = _seqs(informers)
            lines.append(ctrl.step().line())
            # the two decision annotations reach the jobs cache
            informers.informers[jobs_path].wait_event(
                before[jobs_path] + 1, 5)
            reads_from = len(api.log)
            lines.append(ctrl.step().line())
            idle_reads = [e for e in api.log[reads_from:]
                          if e[0] == "GET" and "watch=1" not in e[1]]
            before = _seqs(informers)
            api.set_node_ready(B, ready=False)
            _settle(informers, {NODES: before[NODES]})
            lines.append(ctrl.step().line())
            before = _seqs(informers)
            api.set_node_ready(B, ready=True)
            _settle(informers, {NODES: before[NODES]})
            lines.append(ctrl.step().line())
        finally:
            informers.stop()
        return {"lines": lines, "idle_reads": idle_reads,
                "relists": sorted(i.relists
                                  for i in informers.informers.values())}

    NODES = "/api/v1/nodes"
    out = _run_both(monkeypatch, drive)
    for name, (result, wire, log, store) in out.items():
        opens = {u.partition("?")[0] for _m, u, _b, _c in wire
                 if "watch=1" in u}
        assert opens == {NODES, f"/apis/batch/v1/namespaces/{NS}/jobs"}
        # the fake numbers continue tokens across collections, in the
        # order the two informers' pages happen to arrive
        def token(url):
            return re.sub(r"continue=ct-\d+", "continue=ct-N", url)

        out[name] = (result,
                     [(m, token(u), b, c) for m, u, b, c in wire
                      if "watch=1" not in u],
                     [(m, token(u)) for m, u in log if "watch=1" not in u],
                     store)
    _assert_same(out, multiset=True)
    assert out["port"][0]["idle_reads"] == []
    assert "1 admitted" in out["port"][0]["lines"][0]


# ---------------------------------------------------------------- CLI


def _cli(main, argv):
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        rc = main(argv)
    return rc, buf.getvalue(), err.getvalue()


def _fold(doc):
    return json.loads(re.sub(r" {2,}", "  ", json.dumps(doc)))


def test_cli_queue_and_admission_once_match_the_reference(tmp_path):
    """`admission --once` then `queue` (table, one gang, JSON, an absent
    gang) on both CLIs: equal exit codes and output once names map."""
    out = {}
    for pkg, main in ((REF, ref_cli.main), (PORT, cli.main)):
        with FakeApiServer(auto_ready=True) as api:
            client = pkg.kubeapply.Client(api.url)
            seed_hosts(pkg, client, (A, B, C))
            client.apply(gang_job(pkg, "show", "v5e-16", priority=3))
            client.apply(gang_job(pkg, "wait", "v5e-16"))
            client.patch_merge(f"/api/v1/nodes/{C}", {
                "spec": {"unschedulable": True},
                "metadata": {"annotations": {
                    pkg.admission.MAINTENANCE_ANNOTATION: "g/0"}}})
            client.close()
            base = ["--apiserver", api.url, "--namespace", NS]
            metrics = tmp_path / f"{pkg.name}.prom"
            runs = [_cli(main, ["admission", *base, "--once",
                                "--metrics-out", str(metrics)]),
                    _cli(main, ["queue", *base]),
                    _cli(main, ["queue", *base, "show"]),
                    _cli(main, ["queue", *base, "--json"]),
                    _cli(main, ["queue", *base, "absent", "--json"]),
                    _cli(main, ["queue", "--namespace", NS]),
                    _cli(main, ["admission", "--once"])]
            prom = sorted(line for line in metrics.read_text().splitlines()
                          if line.startswith("tpuctl_admissions_total"))
            out[pkg.name] = json.dumps([runs, prom]).replace(api.url, "URL")
    # the tables' columns are as wide as their widest cell, and a layout
    # is wider than a type: compare with blank runs folded
    want = to_port(out["reference"]).replace(": chips ", ": cards ")
    assert _fold(json.loads(out["port"])) == _fold(json.loads(want))
    runs = json.loads(out["port"])[0]
    assert runs[0][0] == 0 and "1 admitted" in runs[0][1]
    assert "node-a: cards 0,1,2,3,4,5,6,7" in runs[2][1]
    assert "cordoned for maintenance:" in runs[1][1]
    assert runs[4][0] == 1 and runs[5][0] == 2 and runs[6][0] == 2


def test_cli_queue_json_runs_without_pyyaml():
    with FakeApiServer(auto_ready=True) as api:
        client = PORT.kubeapply.Client(api.url)
        seed_hosts(PORT, client, (A,), "v5p-8")
        client.apply(gang_job(PORT, "solo", "v5p-8"))
        PORT.admission.AdmissionController(client, NS).step()
        client.close()
        code = ("import runpy, sys\nsys.modules['yaml'] = None\n"
                "runpy.run_module('tpu_cluster_torch', run_name='__main__', "
                "alter_sys=True)\n")
        proc = subprocess.run(
            [sys.executable, "-c", code, "queue", "--apiserver", api.url,
             "--namespace", NS, "--json"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert [(g["name"], g["status"], g["accelerator"], g["hosts"])
            for g in doc["gangs"]] == [
        ("solo", "admitted", "h100-sxm5-80gb-1", [["node-a", [0]]])]
