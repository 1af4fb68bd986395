"""The port's apply engine (``tpu_cluster_torch.kubeapply``) against the
reference's (``tpu_cluster.kubeapply``): the same groups -- the port's
rendered operands, operator install and validation Jobs -- go through
both engines, each against its own in-process fake apiserver, and what
reached the wire must be the same.

What is compared, exactly unless a test says otherwise:
- the wire log: every request either client put on the wire (method,
  URL, body, Content-Type), recorded at ``http.client`` with W3C
  traceparent ids masked;
- the fake apiserver's own request log (method, path) and its final
  store;
- retries, the exceptions raised, and the kubectl backend's argv and
  stdin.
The pipelined engine runs requests of one dependency tier concurrently,
so there the logs are compared as multisets and the group order is
checked on each side. Nothing here waits more than a second.
"""

import json
import os
import subprocess
import sys

import pytest

from fake_apiserver import FakeApiServer
from torch_apply_helpers import Wire, no_nagle  # noqa: F401
from tpu_cluster import kubeapply as ref_kubeapply
from tpu_cluster_torch import __main__ as cli
from tpu_cluster_torch import kubeapply, lint, telemetry
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch.render import jobs, manifests, operator_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = (("reference", ref_kubeapply), ("port", kubeapply))
STAGE_TIMEOUT = 10
POLL = 0.02


def retry_policy(mod):
    return mod.RetryPolicy(attempts=5, base_s=0.01, cap_s=0.05)


@pytest.fixture(scope="module")
def spec():
    return specmod.default_spec()


@pytest.fixture(scope="module")
def groups(spec):
    """The port's whole stack as one rollout: operand groups, operator
    install waves, the validation Jobs."""
    return (manifests.rollout_groups(spec)
            + operator_bundle.operator_install_groups(spec)
            + [jobs.render_validation_jobs(spec.gpu)])


@pytest.fixture()
def wire(monkeypatch):
    return Wire(monkeypatch)


def run_both(wire, drive, server=None, client_kw=None):
    """``drive(mod, client, api)`` once per engine against a fresh fake
    apiserver built from ``server()`` kwargs; returns {engine: record}."""
    out = {}
    for name, mod in ENGINES:
        with FakeApiServer(**(server() if server else {"auto_ready": True})
                           ) as api:
            client = mod.Client(api.url, retry=retry_policy(mod),
                                **(client_kw or {}))
            try:
                try:
                    result = drive(mod, client, api)
                except mod.ApplyError as exc:
                    result = exc
            finally:
                client.close()
            out[name] = {"result": result, "wire": wire.take(),
                         "log": list(api.log), "store": api.snapshot(),
                         "retries": client.retries}
    return out


def stable(store):
    """The store without what the fake stamps in arrival order (uid,
    resourceVersion): concurrent applies arrive in either order."""
    out = {}
    for path, obj in store.items():
        obj = json.loads(json.dumps(obj))
        for key in ("uid", "resourceVersion"):
            obj.get("metadata", {}).pop(key, None)
        out[path] = obj
    return out


def assert_same_wire(out):
    ref, port = out["reference"], out["port"]
    assert port["wire"] == ref["wire"]
    assert port["log"] == ref["log"]
    assert port["store"] == ref["store"]
    assert port["retries"] == ref["retries"]


def mutations(records):
    return [r for r in records if r[0] in ("POST", "PUT", "PATCH", "DELETE")]


@pytest.mark.parametrize("apply_mode", ["ssa", "merge"])
def test_sequential_rollout_sends_the_same_requests(wire, groups,
                                                    apply_mode):
    def drive(mod, client, api):
        return mod.apply_groups(client, groups, wait=True,
                                stage_timeout=STAGE_TIMEOUT, poll=POLL,
                                apply_mode=apply_mode).actions

    out = run_both(wire, drive)
    assert_same_wire(out)
    assert out["port"]["result"] == out["reference"]["result"]
    assert len(out["port"]["result"]) == sum(len(g) for g in groups)
    assert out["port"]["store"]  # every rendered object landed
    kinds = {o["kind"] for g in groups for o in g}
    stored = {o["kind"] for o in out["port"]["store"].values()}
    assert kinds <= stored


def test_pipelined_rollout_sends_the_same_requests_tier_by_tier(wire,
                                                                groups):
    def drive(mod, client, api):
        return mod.apply_groups(client, groups, wait=True,
                                stage_timeout=STAGE_TIMEOUT, poll=POLL,
                                max_inflight=8).actions

    out = run_both(wire, drive)
    ref, port = out["reference"], out["port"]
    assert sorted(port["wire"]) == sorted(ref["wire"])
    assert sorted(port["log"]) == sorted(ref["log"])
    assert stable(port["store"]) == stable(ref["store"])
    assert sorted(port["result"]) == sorted(ref["result"])
    # groups stay ordered barriers on both sides: every mutation of group
    # i precedes every mutation of group i + 1
    where = {}
    for i, g in enumerate(groups):
        for o in g:
            where.setdefault(kubeapply.object_path(o), set()).add(i)
    where = {p: min(i) for p, i in where.items() if len(i) == 1}
    for rec in (ref, port):
        seq = [where[p.split("?")[0]] for _, p in mutations(rec["log"])
               if p.split("?")[0] in where]
        assert seq == sorted(seq)


def test_retries_under_a_429_and_5xx_fault_script(wire, groups):
    def chaos():
        return {"auto_ready": True, "chaos": [
            {"status": 503, "method": "PATCH", "count": 2},
            {"status": 429, "method": "GET", "count": 2,
             "retry_after": 0.01},
            {"status": 500, "method": "PATCH", "match": "gpu-operator",
             "count": 1},
        ]}

    def drive(mod, client, api):
        return mod.apply_groups(client, groups, wait=True,
                                stage_timeout=STAGE_TIMEOUT, poll=POLL,
                                apply_mode="ssa").actions

    out = run_both(wire, drive, server=chaos)
    assert_same_wire(out)
    assert out["port"]["retries"] == 5


def test_journal_resume_after_a_partial_run(wire, groups, tmp_path):
    """A terminal 403 stops the rollout inside the feature-discovery
    group; the resumed run on the same store skips the journaled groups
    and re-sends the same requests on both engines."""
    stores = {}

    def partial():
        return {"auto_ready": True, "chaos": [
            {"status": 403, "method": "PATCH",
             "match": "daemonsets/gpu-feature-discovery", "count": 1}]}

    def first(mod, client, api):
        journal = mod.RolloutJournal(str(tmp_path / f"{mod.__name__}.j"),
                                     groups)
        try:
            return mod.apply_groups(client, groups, wait=True,
                                    stage_timeout=STAGE_TIMEOUT, poll=POLL,
                                    journal=journal)
        finally:
            journal.close()
            stores[mod.__name__] = api.snapshot()

    out = run_both(wire, first, server=partial)
    assert_same_wire(out)
    for name, _ in ENGINES:
        assert isinstance(out[name]["result"], Exception)
        assert "403" in str(out[name]["result"])

    servers = iter([stores[ref_kubeapply.__name__],
                    stores[kubeapply.__name__]])

    def resumed(mod, client, api):
        journal = mod.RolloutJournal(str(tmp_path / f"{mod.__name__}.j"),
                                     groups, resume=True)
        try:
            assert journal.resumed
            return mod.apply_groups(client, groups, wait=True,
                                    stage_timeout=STAGE_TIMEOUT, poll=POLL,
                                    journal=journal).actions
        finally:
            journal.close()

    out = run_both(wire, resumed, server=lambda: {
        "auto_ready": True, "store": next(servers)})
    assert_same_wire(out)
    # nothing of the three converged groups was re-sent (the Namespace
    # is also in the operator install, which had not run)
    later = {kubeapply.object_path(o) for g in groups[3:] for o in g}
    done = {kubeapply.object_path(o) for g in groups[:3]
            for o in g} - later
    assert done
    assert not [r for r in mutations(out["port"]["log"])
                if r[1].split("?")[0] in done]


def test_deadline_exceeded_on_both_engines(wire, groups):
    """Nothing becomes Ready, so the rollout-wide budget runs out in the
    first workload group's ready-wait. Poll counts depend on the clock,
    so only the mutations are compared."""
    def drive(mod, client, api):
        client.budget = mod.DeadlineBudget(0.3)
        return mod.apply_groups(client, groups, wait=True,
                                stage_timeout=STAGE_TIMEOUT, poll=POLL)

    out = run_both(wire, drive, server=lambda: {"auto_ready": False})
    ref, port = out["reference"], out["port"]
    assert type(ref["result"]).__name__ == "DeadlineExceeded"
    assert type(port["result"]).__name__ == "DeadlineExceeded"
    assert isinstance(port["result"], kubeapply.DeadlineExceeded)
    assert mutations(port["wire"]) == mutations(ref["wire"])
    assert port["store"] == ref["store"]


def test_delete_groups_sends_the_same_requests(wire, groups):
    def drive(mod, client, api):
        mod.apply_groups(client, groups, wait=False, apply_mode="ssa")
        wire.take()  # compare the delete's requests only
        before = len(api.log)
        result = mod.delete_groups(client, groups)
        del api.log[:before]
        return result.actions

    out = run_both(wire, drive)
    assert_same_wire(out)
    assert out["port"]["store"] == {}
    assert out["port"]["result"] == out["reference"]["result"]


class KubectlStub:
    """Records every kubectl argv and stdin; answers like a healthy
    cluster (rollout status/wait succeed, a `get` reports a scheduled
    DaemonSet and an Established CRD)."""

    def __init__(self):
        self.calls = []

    def __call__(self, argv, input_text=None):
        self.calls.append((list(argv), input_text))
        if argv[1] == "get":
            return 0, json.dumps({
                "kind": "DaemonSet",
                "status": {"desiredNumberScheduled": 1, "numberReady": 1,
                           "conditions": [{"type": "Established",
                                           "status": "True"}]}}), \
                "Warning: a deprecation notice on stderr"
        return 0, "ok", ""


def test_kubectl_backend_sends_the_same_argv_and_stdin(groups):
    calls = {}
    for name, mod in ENGINES:
        stub = KubectlStub()
        applied = mod.apply_groups_kubectl(groups, wait=True,
                                           stage_timeout=STAGE_TIMEOUT,
                                           runner=stub)
        deleted = mod.delete_groups_kubectl(groups, runner=stub)
        calls[name] = (stub.calls, applied.actions, deleted.actions)
    assert calls["port"] == calls["reference"]
    argvs = [c[0] for c in calls["port"][0]]
    assert sum(a[:3] == ["kubectl", "apply", "-f"] for a in argvs) \
        == len(groups)
    assert any(a[1] == "delete" for a in argvs)


def test_lint_gate_error_blocks_before_the_first_request(spec):
    """An R01 duplicate in the bundle: ``lint_mode="error"`` raises
    ``LintGateError`` (an ``ApplyError``) from ``lint.gate`` and the
    server sees no request; ``warn`` proceeds."""
    ds = manifests.device_plugin(spec)
    bad = [[manifests.namespace(spec)], [ds], [json.loads(json.dumps(ds))]]
    with FakeApiServer(auto_ready=True) as api:
        client = kubeapply.Client(api.url)
        try:
            with pytest.raises(lint.LintGateError) as err:
                kubeapply.apply_groups(client, bad, wait=True,
                                       lint_mode="error", lint_spec=spec)
            assert isinstance(err.value, kubeapply.ApplyError)
            assert "nothing was applied" in str(err.value)
            assert api.log == []
            logged = []
            kubeapply.apply_groups(client, bad, wait=False, lint_mode="warn",
                                   lint_spec=spec, log=logged.append)
            assert any(line.startswith("lint: R01") for line in logged)
            assert api.log
        finally:
            client.close()


def test_lint_gate_is_the_apply_engines_lint(monkeypatch, spec):
    seen = []
    monkeypatch.setattr(lint, "gate",
                        lambda groups, mode, **kw: seen.append(mode) or [])
    kubeapply._lint_gate([[manifests.namespace(spec)]], "error", spec,
                         lambda msg: None)
    assert seen == ["error"]


# ---------------------------------------------------------------- CLI


def run_cli(*argv, block_yaml=False):
    code = ("import runpy, sys\n"
            + ("sys.modules['yaml'] = None\n" if block_yaml else "")
            + "runpy.run_module('tpu_cluster_torch', run_name='__main__', "
              "alter_sys=True)\n")
    return subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_cli_apply_rest_path_without_pyyaml(tmp_path):
    trace = tmp_path / "trace.json"
    with FakeApiServer(auto_ready=True) as api:
        proc = run_cli("apply", "--apiserver", api.url, "--wait",
                       "--poll", "0.05", "--trace-out", str(trace),
                       "--metrics-out", str(tmp_path / "m.prom"),
                       "--flight-recorder", str(tmp_path / "fr.json"),
                       block_yaml=True)
        assert proc.returncode == 0, proc.stderr
        assert "apply: converged" in proc.stdout
        assert "rollout phases: apply" in proc.stdout
        paths = {kubeapply.object_path(o)
                 for g in manifests.rollout_groups(specmod.default_spec())
                 for o in g}
        assert paths <= set(api.store)
    doc = json.loads(trace.read_text())
    assert any(e["name"] == "rollout" for e in doc["traceEvents"])
    assert "tpuctl_requests_total" in (tmp_path / "m.prom").read_text()
    assert json.loads((tmp_path / "fr.json").read_text())[
        "otherData"]["flight_recorder"] is True
    # the kubectl backend and render still need PyYAML: the block bites
    proc = run_cli("render", "--only", "jobs", block_yaml=True)
    assert proc.returncode != 0


def test_cli_apply_flags_and_exit_codes(capsys):
    assert cli.main(["apply", "--resume"]) == 2
    assert "--resume needs --journal" in capsys.readouterr().err
    assert cli.main(["apply", "--parallel", "--max-inflight", "1"]) == 2
    assert cli.main(["apply", "--token-file", "x"]) == 2
    assert "need --apiserver" in capsys.readouterr().err
    with FakeApiServer(auto_ready=True,
                       chaos=[{"status": 403, "method": "PATCH",
                               "count": 1}]) as api:
        rc = cli.main(["apply", "--apiserver", api.url, "--poll", "0.02",
                       "--flight-recorder", "off", "--retry-base", "0.01"])
    assert rc == 1
    assert "apply failed:" in capsys.readouterr().err


def test_cli_apply_operator_then_delete(capsys):
    with FakeApiServer(auto_ready=True) as api:
        assert cli.main(["apply", "--apiserver", api.url, "--operator",
                         "--parallel", "--watch", "--poll", "0.02",
                         "--flight-recorder", "off"]) == 0
        out = capsys.readouterr().out
        assert "apply: converged" in out
        dep = api.get("/apis/apps/v1/namespaces/gpu-system/deployments/"
                      f"{operator_bundle.OPERATOR_NAME}")
        assert dep is not None
        assert cli.main(["delete", "--apiserver", api.url,
                         "--operator"]) == 0
        assert "delete: done" in capsys.readouterr().out
        assert api.store == {}


def test_cli_delete_kubectl_backend_rejects_rest_flags(capsys):
    assert cli.main(["delete", "--ca-file", "ca.pem"]) == 2
    assert "need --apiserver" in capsys.readouterr().err


def test_cli_apply_writes_the_telemetry_outputs(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.prom"
    with FakeApiServer(auto_ready=True) as api:
        assert cli.main(["apply", "--apiserver", api.url, "--poll", "0.02",
                         "--trace-out", str(trace), "--metrics-out",
                         str(metrics), "--flight-recorder", "off"]) == 0
    out = capsys.readouterr().out
    assert f"apply: trace written to {trace}" in out
    assert f"apply: metrics written to {metrics}" in out
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"rollout", "group-1", "apply", "ready-wait"} <= names
    assert telemetry.REQUESTS_TOTAL in metrics.read_text()
