"""The port's rolling maintenance (``tpu_cluster_torch.maintenance``)
against the reference's (``tpu_cluster/maintenance.py``) under the gang
model's type map (``torch_apply_helpers.TYPE_MAP``).

What is compared, exactly unless a test says otherwise, once the
reference's names are mapped to the port's (``to_port``): wave plans and
the budget's decisions; the state document and its fail-closed parse;
whole waves driven by both packages' admission and maintenance
controllers in lockstep against two fake apiservers -- every pass line
and transition, the wire (bodies with the clock and traceparents
masked), the server's log, and what the controllers wrote to the store
(ConfigMaps, Job annotations, the Nodes' cordon and version, Events);
the CLI's ``maintain plan|run|status``. The drives are deterministic
pass sequences: nothing here sleeps.
"""

import io
import json
import re
from contextlib import redirect_stderr, redirect_stdout

import pytest

from fake_apiserver import FLEET_VERSION_LABEL, FakeApiServer
from torch_apply_helpers import (TYPE_MAP, Wire, controller_store,  # noqa: F401
                                 gang_job, mask_clock, no_nagle, packages,
                                 seed_hosts, to_port)
from tpu_cluster import __main__ as ref_cli
from tpu_cluster_torch import __main__ as cli

REF, PORT = packages()
PACKAGES = (REF, PORT)
NS = "gpu-system"
HOSTS = [f"node-{c}" for c in "abcd"]


def _component(pkg):
    return "gpu-maintenance" if pkg is PORT else "tpu-maintenance"


def _host_caps(pkg, specs):
    """specs: (name, reference per-host type)."""
    out = []
    for name, host_type in specs:
        acc = host_type if pkg is REF else TYPE_MAP[host_type][0]
        out.append(pkg.admission.host_capacity(
            pkg.admission.node_manifest(name, acc)))
    return out


def _plan_doc(plan):
    return {"target": plan.target_version,
            "budget": [plan.budget.max_drained_gangs,
                       plan.budget.min_available_groups],
            "groups": [[g.name, list(g.hosts)] for g in plan.groups]}


# ------------------------------------------------------------------ units


def test_contract_names():
    ref, port = REF.maintenance, PORT.maintenance
    for name in ("MAINTENANCE_KEY", "MAINTENANCE_SCHEMA_VERSION",
                 "VERSION_LABEL", "PHASES", "EVENT_CORDON_STARTED",
                 "EVENT_GANG_DRAINED", "EVENT_UPGRADE_APPLIED",
                 "EVENT_UNCORDONED", "EVENT_WAVE_COMPLETE"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.MAINTENANCE_CONFIGMAP == "gpu-maintenance-state"
    assert port.VERSION_LABEL == FLEET_VERSION_LABEL


@pytest.mark.parametrize("group_size", [1, 2, 3])
def test_plan_waves_groups_by_layout_and_chunks(group_size):
    """Hosts of two layouts (the reference: two per-host types) chunk
    into the same groups, never mixing layouts."""
    specs = ([(f"e-{i}", "v5e-8") for i in range(3)]
             + [(f"p-{i}", "v5p-8") for i in range(2)])
    budget = {pkg.name: pkg.maintenance.GangDisruptionBudget(2, 1)
              for pkg in PACKAGES}
    plans = {pkg.name: _plan_doc(pkg.maintenance.plan_waves(
        _host_caps(pkg, specs), "v9", group_size=group_size,
        budget=budget[pkg.name])) for pkg in PACKAGES}
    # layouts take their turns in name order, which the map does not
    # keep (v5e < v5p, but -8 > -1): equal chunks, each group one layout
    ref, port = plans["reference"], plans["port"]
    assert (port["target"], port["budget"]) == (ref["target"],
                                                ref["budget"])
    assert sorted(h for _n, h in port["groups"]) == \
        sorted(h for _n, h in ref["groups"])
    assert [n for n, _h in port["groups"]] == \
        [f"g/{i}" for i in range(len(ref["groups"]))]
    for _n, hosts in port["groups"]:
        assert len({h[0] for h in hosts}) == 1
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            pkg.maintenance.plan_waves(_host_caps(pkg, specs), "v9",
                                       group_size=0)
    names = [f"g/{i}" for i in (10, 2, 0, 11)]
    assert sorted(names, key=PORT.maintenance._group_key) == \
        sorted(names, key=REF.maintenance._group_key) == \
        ["g/0", "g/2", "g/10", "g/11"]


def _state_doc(pkg):
    plan = pkg.maintenance.plan_waves(
        _host_caps(pkg, [(f"h-{i}", "v5e-8") for i in range(4)]), "v9",
        group_size=2, budget=pkg.maintenance.GangDisruptionBudget(2, 1))
    state = pkg.maintenance.state_from_plan(plan)
    state.groups["g/0"].phase = pkg.maintenance.PHASE_DRAINED
    state.groups["g/0"].draining = {
        "train": "v5e-16" if pkg is REF else "h100-sxm5-80gb-8"}
    return pkg.maintenance.build_state(state)


def test_state_document_round_trips_canonically():
    docs = {}
    for pkg in PACKAGES:
        doc = _state_doc(pkg)
        back = pkg.maintenance.parse_state(json.loads(json.dumps(doc)))
        assert pkg.maintenance.build_state(back) == doc
        docs[pkg.name] = json.dumps(doc, sort_keys=True)
    assert docs["port"] == to_port(docs["reference"])


MUTATIONS = {
    "version": lambda d: d.update(version=2),
    "groups": lambda d: d.update(groups="nope"),
    "phase": lambda d: d["groups"]["g/0"].update(phase="zombie"),
    "hosts": lambda d: d["groups"]["g/0"].update(hosts=[1]),
    "draining": lambda d: d["groups"]["g/0"].update(draining="x"),
    "budget": lambda d: d.update(budget="x"),
}


@pytest.mark.parametrize("needle", sorted(MUTATIONS))
def test_parse_state_fails_closed_as_the_reference(needle):
    messages = []
    for pkg in PACKAGES:
        doc = json.loads(json.dumps(_state_doc(pkg)))
        MUTATIONS[needle](doc)
        with pytest.raises(ValueError, match=needle) as info:
            pkg.maintenance.parse_state(doc)
        messages.append(str(info.value))
    assert messages[1] == messages[0]


# ------------------------------------------------------------ whole waves


def _lockstep(monkeypatch, setup, passes, fresh=False, events=True,
              budget=None, group_size=2):
    """Both packages: ``setup(pkg, client)`` seeds a fake, then
    ``passes`` rounds of one admission pass and one maintenance pass
    (a fresh maintenance controller each round with ``fresh``).
    Returns {package: (per-round record, wire, server log, store)}."""
    wire = Wire(monkeypatch)
    out = {}
    for pkg in PACKAGES:
        with FakeApiServer(auto_ready=True) as api:
            client = pkg.kubeapply.Client(api.url)
            setup(pkg, client)
            adm = pkg.admission.AdmissionController(client, NS)
            adm.step()
            b = budget or (1, 0)
            plan = pkg.maintenance.plan_from_cluster(
                client, "v9", group_size=group_size,
                budget=pkg.maintenance.GangDisruptionBudget(*b))
            wire.take()
            tel = pkg.telemetry.Telemetry()

            def controller():
                rec = (pkg.events.EventRecorder(
                    client, component=_component(pkg)) if events else None)
                return pkg.maintenance.MaintenanceController(
                    client, NS, plan=plan, telemetry=tel, events=rec)

            mctrl = controller()
            rounds = []
            for _ in range(passes):
                adm_line = adm.step().line()
                if fresh:
                    mctrl = controller()
                res = mctrl.step()
                rounds.append([adm_line, res.line(), res.transitions,
                               res.blocked_on, res.draining])
            metrics = sorted(
                line for line in tel.metrics.render().splitlines()
                if line.startswith(("tpu_maintenance_transitions_total",
                                    "tpu_maintenance_waves_total",
                                    "tpu_maintenance_draining_gangs",
                                    "tpu_maintenance_cordoned_hosts",
                                    "tpu_maintenance_group_seconds_count")))
            client.close()
            out[pkg.name] = ({"rounds": rounds, "metrics": metrics,
                              "plan": _plan_doc(plan),
                              "max_drains": mctrl.max_concurrent_drains},
                             wire.take(), list(api.log),
                             controller_store(api))
    return out


def _assert_same(out):
    def masked(rec):
        result, wire, log, store = rec
        return [result, [(m, u, mask_clock(b), c) for m, u, b, c in wire],
                log, store]

    want = json.loads(to_port(json.dumps(masked(out["reference"]))))
    got = json.loads(json.dumps(masked(out["port"])))
    assert got[0] == want[0]
    assert got[3] == want[3]
    assert got[2] == want[2]
    assert got[1] == want[1]


def _one_gang(pkg, client):
    seed_hosts(pkg, client, HOSTS)
    client.apply(gang_job(pkg, "train", "v5e-16", namespace=NS))


def _wave_reasons(store):
    return [(e["reason"], e["message"]) for e in store["events"]
            if e["object"][0] == "ConfigMap"]


def test_a_wave_rolls_the_same_way_on_both_controllers(monkeypatch):
    """Four eight-card hosts in two groups, one 2-host gang resident:
    every phase transition lands in the same pass, the gang drains whole
    and re-admits, and the Nodes end uncordoned on the target."""
    out = _lockstep(monkeypatch, _one_gang, passes=12)
    _assert_same(out)
    rounds = out["port"][0]["rounds"]
    phases = [p for r in rounds for _g, p in r[2]]
    assert phases.count("done") == 2 and "wave complete" in rounds[-1][1]
    store = out["port"][3]
    for h in HOSTS:
        node = store[f"/api/v1/nodes/{h}"]
        assert node["version"] == "v9" and not node["unschedulable"]
    reasons = [r for r, _m in _wave_reasons(store)]
    assert reasons.count("CordonStarted") == 2
    assert reasons.count("WaveComplete") == 1


def test_the_budget_holds_the_next_group_the_same_way(monkeypatch):
    """max_drained_gangs=1, two one-host gangs in separate groups: the
    second group waits for the first gang's re-admission."""
    def setup(pkg, client):
        seed_hosts(pkg, client, HOSTS)
        client.apply(gang_job(pkg, "one", "v5e-8", namespace=NS))
        client.apply(gang_job(pkg, "two", "v5e-8", namespace=NS))

    out = _lockstep(monkeypatch, setup, passes=20, group_size=1)
    _assert_same(out)
    rounds = out["port"][0]["rounds"]
    assert rounds[0][3] == "g/1" and rounds[0][4] == 1
    assert out["port"][0]["max_drains"] <= 1
    assert "wave complete" in rounds[-1][1]


def test_resume_after_a_crash_mid_wave(monkeypatch):
    """A fresh maintenance controller every pass (a controller killed
    after each pass): the wave recovers from its ConfigMap, each group
    cordons once, and the events are the long-running loop's."""
    out = _lockstep(monkeypatch, _one_gang, passes=12, fresh=True)
    _assert_same(out)
    reasons = [r for r, _m in _wave_reasons(out["port"][3])]
    assert reasons.count("CordonStarted") == 2


def test_fail_closed_state_parse_recovers_from_the_plan(monkeypatch):
    """A state ConfigMap that is not JSON: both controllers start from
    the plan and republish; with no plan and no state, both refuse."""
    wire = Wire(monkeypatch)
    out = {}
    for pkg in PACKAGES:
        with FakeApiServer(auto_ready=True) as api:
            client = pkg.kubeapply.Client(api.url)
            seed_hosts(pkg, client, ("node-a",))
            client.apply({"apiVersion": "v1", "kind": "ConfigMap",
                          "metadata": {
                              "name": pkg.maintenance.MAINTENANCE_CONFIGMAP,
                              "namespace": NS},
                          "data": {pkg.maintenance.MAINTENANCE_KEY:
                                   "not json"}})
            wire.take()
            with pytest.raises(pkg.kubeapply.ApplyError) as info:
                pkg.maintenance.MaintenanceController(client, "elsewhere") \
                    .step()
            plan = pkg.maintenance.plan_from_cluster(client, "v9")
            result = pkg.maintenance.MaintenanceController(
                client, NS, plan=plan).step()
            state = pkg.maintenance.fetch_state(client, NS)
            client.close()
            out[pkg.name] = json.dumps(
                [str(info.value), result.line(), result.published,
                 pkg.maintenance.format_status(state),
                 [(m, u, b) for m, u, b, _c in wire.take()]])
    want = to_port(out["reference"]).replace("tpuctl maintain", "maintain")
    assert json.loads(out["port"]) == json.loads(want)
    assert json.loads(out["port"])[2] is True


# ---------------------------------------------------------------- CLI


def _cli(main, argv):
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        rc = main(argv)
    return [rc, buf.getvalue(), err.getvalue()]


def test_cli_maintain_plan_run_status_and_queue_cordons():
    out = {}
    for pkg, main in ((REF, ref_cli.main), (PORT, cli.main)):
        with FakeApiServer(auto_ready=True) as api:
            client = pkg.kubeapply.Client(api.url)
            _one_gang(pkg, client)
            pkg.admission.AdmissionController(client, NS).step()
            client.close()
            base = ["--apiserver", api.url, "--namespace", NS]
            runs = [_cli(main, ["maintain", "status", *base]),
                    _cli(main, ["maintain", "plan", *base, "--target", "v9",
                                "--group-size", "2", "--budget", "2"]),
                    _cli(main, ["maintain", "run", *base, "--target", "v9",
                                "--group-size", "2", "--once",
                                "--no-events"]),
                    _cli(main, ["queue", *base]),
                    _cli(main, ["maintain", "run", *base, "--once"]),
                    _cli(main, ["maintain", "status", *base]),
                    _cli(main, ["maintain", "plan", "--target", "v9"])]
            out[pkg.name] = json.dumps(runs).replace(api.url, "URL")
    # the queue table's columns are as wide as their widest cell
    fold = lambda t: json.loads(re.sub(r" {2,}", "  ", t))  # noqa: E731
    assert fold(out["port"]) == fold(to_port(out["reference"]))
    runs = json.loads(out["port"])
    assert [r[0] for r in runs] == [1, 0, 0, 0, 0, 0, 2]
    assert "cordoned for maintenance:" in runs[3][1]
    assert "g/0" in runs[5][1]
