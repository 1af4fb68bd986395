"""The port's serving autoscaler (``tpu_cluster_torch.autoscale``)
against the reference's (``tpu_cluster/autoscale.py``), a replica being
one host of the layout the reference's per-host type maps to
(``torch_apply_helpers.TYPE_MAP``).

What is compared, exactly unless a test says otherwise, once the
reference's names are mapped to the port's (``to_port``):
- ``decide`` on the reference's table of cases (hysteresis, queue
  pressure, min/max, cooldown both ways, fail-open) and the flapping
  soak's pinned sequence;
- the state document, its canonical form and its fail-closed parse;
- ``observe`` on equal TSDB feeds, missing series staying ``None``;
- both controllers with both admission controllers against two fake
  apiservers, on one frozen clock: every pass's verdict, reason,
  replicas, applied and deleted Jobs, the wire (bodies with the clock
  and traceparents masked), the server's log and what the controllers
  wrote to the store (ConfigMaps, Job annotations, Events);
- the CLI's ``autoscale status`` and ``autoscale run --once``.
"""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from fake_apiserver import FakeApiServer
from torch_apply_helpers import (Wire, controller_store, mask_clock,  # noqa: F401
                                 no_nagle, packages, seed_hosts, to_port)
from tpu_cluster import __main__ as ref_cli
from tpu_cluster.workloads import runtime_metrics as ref_runtime_metrics
from tpu_cluster_torch import __main__ as cli
from tpu_cluster_torch.workloads import runtime_metrics

REF, PORT = packages()
PACKAGES = (REF, PORT)
NS = "gpu-system"
DUTY = {"reference": ref_runtime_metrics.DUTY_CYCLE_PERCENT,
        "port": runtime_metrics.DUTY_CYCLE_PERCENT}


def _policy(pkg, **kw):
    base = dict(min_replicas=1, max_replicas=4, duty_high=75.0,
                duty_low=25.0, queue_high=4.0, window_s=30.0,
                cooldown_s=60.0)
    return pkg.autoscale.AutoscalePolicy(**{**base, **kw})


def _view(pkg, duty=None, queue=None, total=1, up=1):
    return pkg.autoscale.MetricsView(targets_total=total, targets_up=up,
                                     duty_percent=duty, queue_depth=queue)


def feed(pkg, tsdb, job, duty, queue=0.0, up=1.0):
    now = tsdb.now()
    tsdb.append(pkg.telemetry.UP, {"job": job}, up, ts=now)
    tsdb.append(DUTY[pkg.name], {"job": job}, duty, ts=now)
    tsdb.append(pkg.telemetry.SERVING_QUEUE_DEPTH, {"job": job}, queue,
                ts=now)


# ------------------------------------------------------------- the law

# (view kwargs, replicas, now_wall, cooldown_until, policy overrides)
DECIDE_CASES = {
    "duty_high": (dict(duty=80.0), 1, 0.0, 0.0, {}),
    "queue_pressure": (dict(duty=50.0, queue=8.0), 2, 0.0, 0.0, {}),
    "band": (dict(duty=50.0, queue=1.0), 2, 0.0, 0.0, {}),
    "idle": (dict(duty=10.0, queue=0.0), 2, 0.0, 0.0, {}),
    "blind": (dict(duty=None, queue=0.0), 3, 0.0, 0.0, {}),
    "floor": (dict(duty=5.0, queue=0.0), 1, 0.0, 0.0, {}),
    "ceiling": (dict(duty=99.0), 4, 0.0, 0.0, {}),
    "cooldown_up": (dict(duty=90.0), 2, 100.0, 150.0, {}),
    "cooldown_down": (dict(duty=5.0, queue=0.0), 2, 100.0, 150.0, {}),
    "cooldown_over": (dict(duty=90.0), 2, 150.0, 150.0, {}),
    "fail_open": (dict(duty=None, queue=None, total=2, up=0), 3, 0.0,
                  0.0, {}),
    "no_targets": (dict(duty=30.0, total=0, up=0), 1, 0.0, 0.0, {}),
    "fleet_phase_law": (dict(duty=63.0, queue=0.0), 1, 0.0, 0.0,
                        dict(max_replicas=2, duty_high=50.0,
                             duty_low=10.0, window_s=5.0,
                             cooldown_s=0.0)),
}


@pytest.mark.parametrize("case", sorted(DECIDE_CASES))
def test_decide_gives_the_reference_decision(case):
    view_kw, replicas, now, until, pol = DECIDE_CASES[case]
    got = [pkg.autoscale.decide(_view(pkg, **view_kw), replicas,
                                _policy(pkg, **pol), now, until)
           for pkg in PACKAGES]
    assert (got[1].verdict, got[1].desired, got[1].reason) == \
        (got[0].verdict, got[0].desired, got[0].reason)


def test_flapping_metric_soak_sequence():
    sequences = []
    for pkg in PACKAGES:
        policy = _policy(pkg)
        replicas, cooldown_until, verdicts = 1, 0.0, []
        for tick in range(8):
            now = tick * 10.0
            duty = 90.0 if tick % 2 == 0 else 10.0
            d = pkg.autoscale.decide(_view(pkg, duty=duty, queue=0.0),
                                     replicas, policy, now, cooldown_until)
            verdicts.append(d.verdict)
            if d.verdict in ("up", "down"):
                replicas = d.desired
                cooldown_until = now + policy.cooldown_s
        sequences.append((verdicts, replicas))
    assert sequences[1] == sequences[0] == (
        ["up", "hold", "hold", "hold", "hold", "hold", "up", "hold"], 3)


def test_policy_defaults_and_validation_are_the_reference():
    ref, port = REF.autoscale.AutoscalePolicy(), \
        PORT.autoscale.AutoscalePolicy()
    assert vars(port) == vars(ref)
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(duty_low=80.0, duty_high=75.0)):
        for pkg in PACKAGES:
            with pytest.raises(ValueError):
                _policy(pkg, **bad).validate()


# ------------------------------------------------------------- state


def test_state_round_trips_and_fails_closed():
    payloads = []
    for pkg in PACKAGES:
        acc = "v5e-8" if pkg is REF else "h100-sxm5-80gb-8"
        state = pkg.autoscale.ScaleState(
            job="serving", accelerator=acc, replicas=3,
            cooldown_until=123.5, last_blocked="at max")
        doc = pkg.autoscale.build_state(state)
        assert pkg.autoscale.parse_state(doc) == state
        payloads.append(json.dumps(doc, sort_keys=True,
                                   separators=(",", ":")))
        messages = []
        for mutation in ({"version": 99}, {"job": ""}, {"replicas": -1},
                         {"replicas": "many"}):
            with pytest.raises(ValueError) as info:
                pkg.autoscale.parse_state({**doc, **mutation})
            messages.append(str(info.value))
        with pytest.raises(ValueError):
            pkg.autoscale.parse_state(["not", "a", "mapping"])
        payloads.append(messages)
    assert payloads[2] == json.loads(to_port(json.dumps(payloads[0])))
    assert payloads[3] == payloads[1]
    assert PORT.autoscale.AUTOSCALE_CONFIGMAP == "gpu-autoscale-state"
    for name in ("AUTOSCALE_KEY", "AUTOSCALE_SCHEMA_VERSION",
                 "SERVING_REPLICA_ANNOTATION", "EVENT_SCALED_UP",
                 "EVENT_SCALED_DOWN", "EVENT_SCALE_BLOCKED"):
        assert getattr(PORT.autoscale, name) == \
            getattr(REF.autoscale, name), name


def test_observe_keeps_missing_series_none():
    views = []
    for pkg in PACKAGES:
        tsdb = pkg.metricsdb.TSDB()
        first = pkg.autoscale.observe(tsdb, 30.0)
        feed(pkg, tsdb, "serving-0", duty=80.0, queue=3.0)
        feed(pkg, tsdb, "serving-1", duty=40.0, queue=2.0, up=0.0)
        tsdb.append(pkg.telemetry.UP, {"job": "serving-2"}, 1.0)
        second = pkg.autoscale.observe(tsdb, 30.0)
        views.append([vars(first), vars(second), second.line()])
    assert views[1] == views[0]
    assert views[1][0]["duty_percent"] is None
    assert views[1][0]["queue_depth"] is None
    assert (views[1][1]["targets_total"], views[1][1]["targets_up"],
            views[1][1]["duty_percent"], views[1][1]["queue_depth"]) == \
        (3, 2, 60.0, 5.0)


def test_replica_manifest_is_a_one_host_gang_job():
    got = PORT.autoscale.replica_manifest("serving", 1, "h100-sxm5-80gb-8",
                                          NS)
    want = REF.autoscale.replica_manifest("serving", 1, "v5e-8", NS)
    assert got == json.loads(to_port(json.dumps(want)))
    assert got["spec"]["completions"] == 1
    assert PORT.admission.gang_of_job(got).hosts == 1
    assert PORT.autoscale.replica_index("serving", "serving-1") == 1
    assert PORT.autoscale.replica_index("serving", "other-1") is None


# -------------------------------------------------------- controllers


class Clock:
    """One frozen clock for the TSDB and the controller (monotonic and
    wall): equal drives read equal times."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _run_both(monkeypatch, drive):
    """``drive(pkg, client, api, make, clock)`` once per package against a
    fresh fake seeded with three eight-card hosts; ``make(tsdb, **kw)``
    builds that package's controller. Returns {package: (result, wire,
    log, store)} with only the drive's requests on the wire."""
    wire = Wire(monkeypatch)
    out = {}
    for pkg in PACKAGES:
        with FakeApiServer(auto_ready=True) as api:
            client = pkg.kubeapply.Client(api.url)
            seed_hosts(pkg, client, [f"as-{i}" for i in range(3)])
            wire.take()
            clock = Clock()
            component = "gpu-autoscale" if pkg is PORT else "tpu-autoscale"

            def make(tsdb, events=True, **kw):
                policy = pkg.autoscale.AutoscalePolicy(**{
                    "min_replicas": 1, "max_replicas": 4,
                    "cooldown_s": 0.0, **kw})
                acc = "v5e-8" if pkg is REF else "h100-sxm5-80gb-8"
                rec = (pkg.events.EventRecorder(client, component=component)
                       if events else None)
                return pkg.autoscale.AutoscaleController(
                    client, NS, job="serving", accelerator=acc,
                    policy=policy, tsdb=tsdb, events=rec, clock=clock,
                    wall_clock=clock)

            try:
                result = drive(pkg, client, api, make, clock)
            finally:
                client.close()
            out[pkg.name] = (result, wire.take(), list(api.log),
                             controller_store(api))
    return out


def _record(res):
    return [res.verdict, res.reason, res.replicas, res.applied, res.deleted,
            res.published, res.events, res.line()]


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


def _scale_out(pkg, client, make, clock):
    """Overload on a fleet that owes replica 0: blocked, admitted, up."""
    adm = pkg.admission.AdmissionController(client, NS)
    tsdb = pkg.metricsdb.TSDB(clock=clock)
    ctrl = make(tsdb)
    feed(pkg, tsdb, "serving-0", duty=95.0)
    r1 = ctrl.step()
    adm.step()
    clock.t += 1.0
    feed(pkg, tsdb, "serving-0", duty=95.0)
    r2 = ctrl.step()
    adm.step()
    return adm, tsdb, ctrl, [r1, r2]


def test_scale_out_waits_for_gang_arbitration(monkeypatch):
    def drive(pkg, client, api, make, clock):
        adm, _tsdb, ctrl, passes = _scale_out(pkg, client, make, clock)
        reaction = passes[1].reaction_s
        return {"passes": [_record(r) for r in passes],
                "admitted": sorted(adm.admitted_snapshot()),
                "reaction": reaction,
                "state": vars(pkg.autoscale.fetch_state(client, NS))}

    out = _run_both(monkeypatch, drive)
    _assert_same(out)
    port = out["port"][0]
    assert [p[0] for p in port["passes"]] == ["blocked", "up"]
    assert "awaiting gang arbitration" in port["passes"][0][1]
    assert port["admitted"] == ["serving/0", "serving/1"]
    assert port["reaction"] == 1.0


def test_fresh_process_resumes_without_duplicate_events(monkeypatch):
    def drive(pkg, client, api, make, clock):
        _scale_out(pkg, client, make, clock)
        calm = pkg.metricsdb.TSDB(clock=clock)
        feed(pkg, calm, "serving-0", duty=50.0)
        feed(pkg, calm, "serving-1", duty=50.0)
        resumed = make(calm).step()
        return _record(resumed)

    out = _run_both(monkeypatch, drive)
    _assert_same(out)
    verdict, _reason, replicas, applied, deleted, published, events, _l = \
        out["port"][0]
    assert (verdict, replicas, applied, deleted, published, events) == \
        ("hold", 2, [], [], False, 0)


def test_scale_in_deletes_one_whole_replica(monkeypatch):
    def drive(pkg, client, api, make, clock):
        adm, tsdb, ctrl, _passes = _scale_out(pkg, client, make, clock)
        for _ in range(8):
            clock.t += 1.0
            feed(pkg, tsdb, "serving-0", duty=5.0)
            feed(pkg, tsdb, "serving-1", duty=5.0)
        down = ctrl.step()
        adm.step()
        return {"down": _record(down),
                "admitted": sorted(adm.admitted_snapshot()),
                "jobs": sorted(client.list_collection(
                    f"/apis/batch/v1/namespaces/{NS}/jobs"))}

    out = _run_both(monkeypatch, drive)
    _assert_same(out)
    port = out["port"][0]
    assert port["down"][:5] == ["down", port["down"][1], 1, [],
                                ["serving-1"]]
    assert port["admitted"] == ["serving/0"]
    assert port["jobs"] == ["serving-0"]


def test_fail_open_pass_still_converges_jobs(monkeypatch):
    def drive(pkg, client, api, make, clock):
        tsdb = pkg.metricsdb.TSDB(clock=clock)
        feed(pkg, tsdb, "serving-0", duty=95.0, up=0.0)
        return _record(make(tsdb, events=False).step())

    out = _run_both(monkeypatch, drive)
    _assert_same(out)
    assert out["port"][0][:4] == ["hold",
                                  "fail-open: all scrape targets down", 1,
                                  ["serving-0"]]


def test_scrape_manager_feeds_the_controller_from_a_live_target(
        monkeypatch):
    """The port's controller scraping a MetricsServer that serves the
    duty and queue gauges under the serving engine's names: the TSDB
    holds the target's series, and the decision is the reference's on
    the same scraped values."""
    from tpu_cluster_torch import metricsdb, telemetry
    reg = telemetry.MetricsRegistry()
    reg.gauge(runtime_metrics.DUTY_CYCLE_PERCENT, "duty").set(88.0)
    reg.gauge(telemetry.SERVING_QUEUE_DEPTH, "queue").set(0.0)
    with metricsdb.MetricsServer(reg, 0) as server, \
            FakeApiServer(auto_ready=True) as api:
        client = PORT.kubeapply.Client(api.url)
        seed_hosts(PORT, client, ["as-0"])
        ctrl = PORT.autoscale.AutoscaleController(
            client, NS, accelerator="h100-sxm5-80gb-8",
            policy=PORT.autoscale.AutoscalePolicy(
                max_replicas=2, duty_high=50.0, duty_low=10.0,
                window_s=5.0, cooldown_s=0.0),
            targets=[metricsdb.Target("serving-0", server.url)])
        adm = PORT.admission.AdmissionController(client, NS)
        first = ctrl.step()
        adm.step()
        second = ctrl.step()
        series = ctrl.tsdb.latest(runtime_metrics.DUTY_CYCLE_PERCENT)
        client.close()
    assert series == {(("job", "serving-0"),): 88.0}
    assert (first.verdict, second.verdict, second.replicas) == \
        ("blocked", "up", 2)
    assert second.reason == REF.autoscale.decide(
        _view(REF, duty=88.0, queue=0.0), 1,
        REF.autoscale.AutoscalePolicy(max_replicas=2, duty_high=50.0,
                                      duty_low=10.0, window_s=5.0,
                                      cooldown_s=0.0), 0.0, 0.0).reason


# ---------------------------------------------------------------- CLI


def _cli(main, argv):
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        rc = main(argv)
    return [rc, buf.getvalue(), err.getvalue()]


def test_cli_autoscale_status_and_once():
    out = {}
    for pkg, main in ((REF, ref_cli.main), (PORT, cli.main)):
        with FakeApiServer(auto_ready=True) as api:
            client = pkg.kubeapply.Client(api.url)
            seed_hosts(pkg, client, ["as-0", "as-1"])
            client.close()
            conn = ["--apiserver", api.url, "--namespace", NS]
            runs = [_cli(main, ["autoscale", "status", *conn]),
                    _cli(main, ["autoscale", "run", "--once", "--cooldown",
                                "0", "--scrape-passes", "1", *conn]),
                    _cli(main, ["autoscale", "status", *conn]),
                    _cli(main, ["autoscale", "run", "--once",
                                "--targets", "nope", *conn]),
                    _cli(main, ["autoscale", "run", "--once",
                                "--min-replicas", "3", "--max-replicas",
                                "2", *conn]),
                    _cli(main, ["autoscale", "status"])]
            out[pkg.name] = json.dumps(runs).replace(api.url, "URL")
    assert json.loads(out["port"]) == json.loads(to_port(out["reference"]))
    runs = json.loads(out["port"])
    assert [r[0] for r in runs] == [1, 0, 0, 2, 2, 2]
    assert "job serving (h100-sxm5-80gb-8), 1 replica(s)" in runs[2][1]
