"""The port's trace readers (``tpu_cluster_torch.telemetry``:
``summarize_trace``, ``validate_chrome_trace``, ``merge_traces``) against
the reference's, and the port's ``top`` and ``trace merge|validate``
CLIs.

Compared exactly: ``summarize_trace`` of the checked-in rollout fixture
equals its golden ``rollout_trace.top.txt`` byte for byte (the port's
``top`` CLI too); both validators accept the same documents, and reject
the same ones with the same message; both mergers give equal documents
on the same inputs; and in the merge of a port CLI trace with the fake
apiserver's ``/__fake_trace`` every non-dropped wire attempt pairs with
exactly one server span. The CLIs run in a subprocess with PyYAML
blocked and keep the reference's rcs (0 ok, 1 invalid trace or failed
merge, 2 unreadable input)."""

import copy
import json
import urllib.request
from collections import Counter

import pytest

from fake_apiserver import FakeApiServer, standard_fault_script
from torch_apply_helpers import FIXTURES, no_nagle, run_port_cli  # noqa: F401
from tpu_cluster import telemetry as ref_telemetry
from tpu_cluster_torch import kubeapply, telemetry
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch.render import manifests, operator_bundle

ROLLOUT = f"{FIXTURES}/rollout_trace.json"
SERVER = f"{FIXTURES}/server_trace.json"
GOLDEN = f"{FIXTURES}/rollout_trace.top.txt"
FAST_RETRY = kubeapply.RetryPolicy(attempts=8, base_s=0.02, cap_s=0.3)


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _http_spans(doc):
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "http"]


def test_summary_of_the_fixture_equals_the_golden_text():
    with open(GOLDEN, encoding="utf-8") as f:
        golden = f.read()
    doc = _load(ROLLOUT)
    assert telemetry.summarize_trace(doc, limit=5) + "\n" == golden
    for limit in (1, 3, 10):
        assert telemetry.summarize_trace(doc, limit=limit) == \
            ref_telemetry.summarize_trace(doc, limit=limit)
    proc = run_port_cli("top", ROLLOUT, "--limit", "5")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == golden


def test_summary_of_a_merged_trace_equals_the_reference(tmp_path):
    merged = telemetry.merge_traces([_load(ROLLOUT), _load(SERVER)])
    text = telemetry.summarize_trace(merged, limit=5)
    assert text == ref_telemetry.summarize_trace(merged, limit=5)
    assert "processes (merged trace):" in text
    assert "pid 1: tpuctl" in text and "pid 2: fake-apiserver" in text
    assert "requests: 6 (GET 2, PATCH 3, POST 1)" in text
    assert "retries: 1" in text
    path = tmp_path / "merged.json"
    path.write_text(json.dumps(merged))
    proc = run_port_cli("top", path, "--limit", "5")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == text + "\n"


def _bad_docs():
    good = _load(ROLLOUT)
    out = [("not-object", [1, 2]), ("no-events", {"not": "a trace"}),
           ("events-not-list", {"traceEvents": {}})]

    def mutate(label, fn):
        doc = copy.deepcopy(good)
        fn(doc["traceEvents"])
        out.append((label, doc))

    mutate("event-not-object", lambda ev: ev.append("x"))
    mutate("name-not-str", lambda ev: ev[0].update(name=3))
    mutate("ph-empty", lambda ev: ev[0].update(ph=""))
    mutate("ts-str", lambda ev: ev[0].update(ts="0"))
    mutate("pid-float", lambda ev: ev[0].update(pid=1.5))
    mutate("tid-str", lambda ev: ev[0].update(tid="1"))
    mutate("dur-negative", lambda ev: [e.update(dur=-1.0) for e in ev
                                       if e.get("ph") == "X"][:1])
    mutate("dur-missing", lambda ev: [e.pop("dur") for e in ev
                                      if e.get("ph") == "X"][:1])
    mutate("args-list", lambda ev: ev[0].update(args=[1]))
    return out


@pytest.mark.parametrize("label,doc", _bad_docs(),
                         ids=[label for label, _ in _bad_docs()])
def test_validator_rejects_what_the_reference_rejects(label, doc):
    errors = []
    for tel in (ref_telemetry, telemetry):
        with pytest.raises(ValueError) as exc:
            tel.validate_chrome_trace(doc)
        errors.append(str(exc.value))
    assert errors[1] == errors[0], label


@pytest.mark.parametrize("path", [ROLLOUT, SERVER])
def test_validator_accepts_what_the_reference_accepts(path):
    doc = _load(path)
    assert telemetry.validate_chrome_trace(doc) == \
        ref_telemetry.validate_chrome_trace(doc) > 0


def test_merge_equals_the_reference_on_the_same_inputs():
    cli, server = _load(ROLLOUT), _load(SERVER)
    no_epoch = copy.deepcopy(server)
    no_epoch["otherData"].pop("epoch", None)
    bare = {"traceEvents": copy.deepcopy(cli["traceEvents"])}
    for docs in ([cli, server], [server, cli], [cli], [cli, no_epoch],
                 [bare, server, cli]):
        merged = telemetry.merge_traces(docs)
        assert merged == ref_telemetry.merge_traces(docs)
        assert telemetry.validate_chrome_trace(merged) > 0
    merged = telemetry.merge_traces([cli, server])
    # the 0.25 s epoch gap shifts the server track right, never left
    server_events = [e for e in merged["traceEvents"]
                     if e.get("pid") == 2 and e.get("ph") == "X"]
    assert server_events and all(e["ts"] >= 250000.0
                                 for e in server_events)
    for e in server_events:
        assert e["args"]["trace_id"] == cli["otherData"]["trace_id"]
    errors = []
    for tel in (ref_telemetry, telemetry):
        with pytest.raises(ValueError) as exc:
            tel.merge_traces([])
        errors.append(str(exc.value))
    assert errors[1] == errors[0]


def test_merged_port_trace_pairs_every_attempt_with_one_server_span():
    """The port's client under the standard chaos script, full bundle,
    watch readiness: every non-dropped CLI attempt has exactly one fake
    apiserver span naming it as parent with the CLI's trace id, and the
    merge of the two (fetched from ``/__fake_trace``) is the reference
    merger's document."""
    spec = specmod.default_spec()
    groups = (list(operator_bundle.operator_install_groups(spec))
              + list(manifests.rollout_groups(spec)))
    tel = telemetry.Telemetry()
    with FakeApiServer(auto_ready=True,
                       chaos=standard_fault_script(0.03)) as api:
        client = kubeapply.Client(api.url, retry=FAST_RETRY, telemetry=tel)
        kubeapply.apply_groups(client, groups, wait=True, stage_timeout=60,
                               poll=0.02, max_inflight=8, watch_ready=True)
        client.close()
        assert client.retries > 0, "the fault script never fired"
        with urllib.request.urlopen(api.url + "/__fake_trace",
                                    timeout=10) as resp:
            server = json.loads(resp.read())
        audit = len(api.log)
    cli = tel.chrome_trace()
    assert len(server["traceEvents"]) == audit
    http = _http_spans(cli)
    parents = Counter(e["args"]["parent_id"] for e in server["traceEvents"])
    client_ids = {e["args"]["span_id"] for e in http}
    for e in http:
        n = parents.get(e["args"]["span_id"], 0)
        if e["args"]["status"] != 0:
            assert n == 1, (e["name"], e["args"], n)
        else:
            assert n <= 1, (e["name"], e["args"], n)
    for e in server["traceEvents"]:
        assert e["args"]["parent_id"] in client_ids, e["args"]
        assert e["args"]["trace_id"] == tel.tracer.trace_id
    merged = telemetry.merge_traces([cli, server])
    assert merged == ref_telemetry.merge_traces([cli, server])
    telemetry.validate_chrome_trace(merged)
    assert {e["pid"] for e in merged["traceEvents"]} == {1, 2}
    assert tel.tracer.trace_id in merged["otherData"]["trace_ids"]


# -------------------------------------------------------------- CLI


def test_trace_merge_and_validate_cli(tmp_path):
    out = tmp_path / "merged.json"
    proc = run_port_cli("trace", "merge", "-o", out, ROLLOUT, SERVER)
    assert proc.returncode == 0, proc.stderr
    merged = _load(out)
    assert merged == ref_telemetry.merge_traces([_load(ROLLOUT),
                                                 _load(SERVER)])
    assert "trace: merged 2 trace(s) (tpuctl, fake-apiserver)" \
        in proc.stdout
    assert f"python -m tpu_cluster_torch top {out}" in proc.stdout
    proc = run_port_cli("trace", "validate", out)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith(f"trace: {out} valid — "
                                  f"{len(merged['traceEvents'])} event(s)")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": 1}]}))
    proc = run_port_cli("trace", "validate", bad)
    assert proc.returncode == 1
    assert "is not a valid Chrome trace" in proc.stderr
    proc = run_port_cli("trace", "merge", "-o", tmp_path / "m2.json", bad)
    assert proc.returncode == 1
    assert proc.stderr.startswith("trace merge: ")
    for argv in (("trace", "validate", tmp_path / "absent.json"),
                 ("trace", "merge", "-o", tmp_path / "m3.json",
                  tmp_path / "absent.json")):
        proc = run_port_cli(*argv)
        assert proc.returncode == 2 and "cannot read" in proc.stderr
    junk = tmp_path / "junk.json"
    junk.write_text("{nope")
    proc = run_port_cli("trace", "validate", junk)
    assert proc.returncode == 2 and "is not JSON" in proc.stderr
    proc = run_port_cli("trace", "merge", "-o", tmp_path / "no" / "x.json",
                        ROLLOUT)
    assert proc.returncode == 2 and "cannot write" in proc.stderr


def test_top_cli_rcs(tmp_path):
    bogus = tmp_path / "bogus.json"
    bogus.write_text('{"not": "a trace"}')
    arr = tmp_path / "arr.json"
    arr.write_text("[1, 2]")
    junk = tmp_path / "junk.json"
    junk.write_text("{nope")
    empty = tmp_path / "empty.json"
    empty.write_text('{"traceEvents": []}')
    for path, want in ((bogus, "not a Chrome trace"),
                       (arr, "not a Chrome trace"),
                       (junk, "is not JSON"),
                       (empty, "no complete (ph=X) span events"),
                       (tmp_path / "absent.json", "cannot read")):
        proc = run_port_cli("top", path)
        assert proc.returncode == 2, (path, proc.stderr)
        assert want in proc.stderr, (path, proc.stderr)
        assert "Traceback" not in proc.stderr


def test_apply_trace_out_names_top_and_top_reads_it(tmp_path):
    trace = tmp_path / "trace.json"
    with FakeApiServer(auto_ready=True) as api:
        proc = run_port_cli("apply", "--apiserver", api.url, "--wait",
                            "--poll", "0.05", "--operator", "--trace-out",
                            trace)
    assert proc.returncode == 0, proc.stderr
    assert (f"summarize with `python -m tpu_cluster_torch top {trace}`"
            in proc.stdout)
    proc = run_port_cli("top", trace, "--limit", "3")
    assert proc.returncode == 0, proc.stderr
    assert "phase breakdown" in proc.stdout
    for phase in telemetry.PHASE_NAMES:
        assert phase in proc.stdout
    assert proc.stdout == ref_telemetry.summarize_trace(
        _load(trace), limit=3) + "\n"
