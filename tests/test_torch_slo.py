"""The port's SLO evaluator (``tpu_cluster_torch.slo``) against the
reference's (``tpu_cluster/slo.py``), and the port's ``slo check`` CLI.

Compared exactly: both packages' ``evaluate`` on the same traces give
equal ``to_dict()`` reports and byte-equal ``format_report`` text
(hand-computed burn rates checked beside them to 1e-6 relative), equal
``samples_for`` per SLO, and the same ``ValueError`` text on junk. The
CLI runs in a subprocess with PyYAML blocked; its rc contract is the
reference's (0 healthy, 1 burning with the window pair named, 2
unreadable) and its table is the reference's ``format_report`` of the
same traces."""

import json

import pytest

from fake_apiserver import FakeApiServer
from torch_apply_helpers import FIXTURES, no_nagle, run_port_cli  # noqa: F401
from tpu_cluster import slo as ref_slo
from tpu_cluster_torch import kubeapply, slo, telemetry
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch.render import manifests

VIOLATION = f"{FIXTURES}/slo_violation_trace.json"
ROLLOUT = f"{FIXTURES}/rollout_trace.json"
SERVER = f"{FIXTURES}/server_trace.json"


def _http_span(ts_s, status, watch=False, dur_us=1000.0):
    args = {"verb": "GET", "status": status}
    if watch:
        args["watch"] = True
    return {"name": "GET /x", "cat": "http", "ph": "X",
            "ts": round(ts_s * 1e6, 1), "dur": dur_us, "pid": 1,
            "tid": 1, "args": args}


def _admission_span(ts_s, dur_s):
    return {"name": "admission-pass", "cat": "admission", "ph": "X",
            "ts": round(ts_s * 1e6, 1), "dur": round(dur_s * 1e6, 1),
            "pid": 1, "tid": 1, "args": {}}


def _trace(events):
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def evaluate_both(docs, **kw):
    """The port's report, after asserting it equals the reference's."""
    ref = ref_slo.evaluate(docs, **kw)
    port = slo.evaluate(docs, **kw)
    assert port.to_dict() == ref.to_dict()
    assert slo.format_report(port) == ref_slo.format_report(ref)
    return port


def _verdict(report, name):
    return {v.slo.name: v for v in report.verdicts}[name]


def _window(verdict, severity):
    return [w for w in verdict.windows if w.severity == severity][0]


def test_definitions_equal_the_reference():
    assert [(s.name, s.description, s.objective, s.families)
            for s in slo.DEFAULT_SLOS] == \
        [(s.name, s.description, s.objective, s.families)
         for s in ref_slo.DEFAULT_SLOS]
    assert [(w.severity, w.short_s, w.long_s, w.factor, w.label())
            for w in slo.DEFAULT_WINDOWS] == \
        [(w.severity, w.short_s, w.long_s, w.factor, w.label())
         for w in ref_slo.DEFAULT_WINDOWS]
    assert slo.ADMISSION_LATENCY_THRESHOLD_S == \
        ref_slo.ADMISSION_LATENCY_THRESHOLD_S


def test_burn_rate_math_against_hand_computed_values():
    """100 s timeline, 10 bad of 100 samples = 10x burn of a 1% budget
    in the long page window; the 5m window (the last 100/12 s) is all
    bad."""
    events = [_http_span(i, 200) for i in range(90)]
    events += [_http_span(90 + i, 0) for i in range(10)]
    av = _verdict(evaluate_both([_trace(events)]), "apply-availability")
    page = _window(av, "page")
    assert page.samples_long == 100
    assert page.burn_long == pytest.approx(10.0, rel=1e-6)
    assert page.burn_short == pytest.approx(100.0, rel=1e-6)
    assert not page.burning
    assert _window(av, "warn").burning


def test_dual_window_gate_a_short_blip_does_not_page():
    events = [_http_span(i * 0.1, 200) for i in range(990)]
    events += [_http_span(99.0 + i * 0.02, 0) for i in range(30)]
    av = _verdict(evaluate_both([_trace(events)]), "apply-availability")
    page = _window(av, "page")
    assert page.burn_short > 14.4
    assert page.burn_long < 14.4
    assert not page.burning


def test_watch_uptime_and_admission_latency_extractors():
    doc = _trace([_http_span(1.0, 200, watch=True),
                  _http_span(2.0, 403, watch=True),
                  _admission_span(3.0, 0.01),
                  _admission_span(4.0, 5.0)])
    for port_def, ref_def in zip(slo.DEFAULT_SLOS, ref_slo.DEFAULT_SLOS):
        assert slo.samples_for(port_def, doc) == \
            ref_slo.samples_for(ref_def, doc)
    by_name = {s.name: s for s in slo.DEFAULT_SLOS}
    assert sorted(g for _t, g in slo.samples_for(by_name["watch-uptime"],
                                                 doc)) == [False, True]
    assert sorted(g for _t, g in slo.samples_for(
        by_name["admission-latency"], doc)) == [False, True]
    assert slo.samples_for(by_name["apply-availability"], doc) == []
    evaluate_both([doc])


def test_429_and_5xx_count_against_availability_404_does_not():
    doc = _trace([_http_span(1.0, 200), _http_span(2.0, 404),
                  _http_span(3.0, 429), _http_span(4.0, 503),
                  _http_span(5.0, 0), _http_span(6.0, "junk")])
    avail = slo.DEFAULT_SLOS[0]
    assert avail.name == "apply-availability"
    good = sorted(g for _t, g in slo.samples_for(avail, doc))
    assert good == [False, False, False, False, True, True]
    for status in (0, 200, 404, 429, 499, 500, 503, None, "x", "503"):
        assert slo._is_bad_status(status) == \
            ref_slo._is_bad_status(status), status
    evaluate_both([doc])


@pytest.mark.parametrize("scale", [1.0, 36.0, None])
def test_scale_controls_window_mapping(scale):
    events = [_http_span(i, 200 if i % 2 else 0) for i in range(100)]
    report = evaluate_both([_trace(events)], scale=scale)
    page = _window(_verdict(report, "apply-availability"), "page")
    if scale == 1.0:
        assert report.scale == 1.0
        assert page.burn_short == pytest.approx(page.burn_long)


def test_no_samples_is_healthy_but_visible():
    report = evaluate_both([_trace([_admission_span(1.0, 0.01)])])
    av = _verdict(report, "apply-availability")
    assert av.total_samples == 0 and not av.burning
    assert report.ok
    assert "no samples" in slo.format_report(report)


@pytest.mark.parametrize("docs", [[], [{"not": "a trace"}],
                                  [{"traceEvents": "nope"}]])
def test_evaluate_rejects_junk(docs):
    errors = []
    for mod in (ref_slo, slo):
        with pytest.raises(ValueError) as exc:
            mod.evaluate(docs)
        errors.append(str(exc.value))
    assert errors[1] == errors[0]


@pytest.mark.parametrize("paths", [[ROLLOUT], [VIOLATION], [SERVER],
                                   [ROLLOUT, SERVER]])
def test_fixture_traces_give_the_reference_report(paths):
    docs = [slo.load_trace(p) for p in paths]
    assert docs == [ref_slo.load_trace(p) for p in paths]
    evaluate_both(docs)


def test_evaluate_sources_equals_the_reference():
    samples = [(float(i), i % 7 != 0) for i in range(50)]
    for span_s in (0.0, 49.0):
        reports = [mod.evaluate_sources(
            {"apply-availability": mod.source_from_samples(samples)},
            span_s=span_s) for mod in (ref_slo, slo)]
        assert reports[1].to_dict() == reports[0].to_dict()


# -------------------------------------------------------------- CLI


def _ref_text(paths):
    return ref_slo.format_report(ref_slo.evaluate(
        [ref_slo.load_trace(p) for p in paths])) + "\n"


def test_cli_rc0_on_a_healthy_trace_and_rc1_naming_the_window_pair():
    proc = run_port_cli("slo", "check", SERVER)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert proc.stdout == _ref_text([SERVER])
    assert "all budgets healthy" in proc.stdout
    proc = run_port_cli("slo", "check", VIOLATION)
    assert proc.returncode == 1, (proc.stdout, proc.stderr)
    assert proc.stdout == _ref_text([VIOLATION])
    assert "error budget burning" in proc.stdout
    assert "apply-availability: page (5m/1h), warn (6h/3d)" in proc.stdout
    proc = run_port_cli("slo", "check", VIOLATION, "--json")
    assert proc.returncode == 1
    doc = json.loads(proc.stdout)
    assert doc == ref_slo.evaluate([ref_slo.load_trace(VIOLATION)]).to_dict()
    page = _window(_verdict(slo.evaluate([slo.load_trace(VIOLATION)]),
                            "apply-availability"), "page")
    assert page.burning and page.burn_short > 14.4 \
        and page.burn_long > 14.4


def test_cli_junk_input_is_rc2(tmp_path):
    bogus = tmp_path / "bogus.json"
    bogus.write_text('{"not": "a trace"}')
    proc = run_port_cli("slo", "check", bogus)
    assert proc.returncode == 2, proc.stdout
    assert "no traceEvents" in proc.stderr
    proc = run_port_cli("slo", "check", tmp_path / "absent.json")
    assert proc.returncode == 2
    assert "cannot read" in proc.stderr
    bogus.write_text("[1, 2]")
    proc = run_port_cli("slo", "check", bogus)
    assert proc.returncode == 2
    assert "not a trace" in proc.stderr


def test_cli_pools_samples_across_traces(tmp_path):
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps(_trace([_http_span(i, 200)
                                    for i in range(10)])))
    b.write_text(json.dumps(_trace([_http_span(i, 200)
                                    for i in range(5)])))
    proc = run_port_cli("slo", "check", a, b, "--json")
    assert proc.returncode == 0
    doc = json.loads(proc.stdout)
    av = [s for s in doc["slos"] if s["name"] == "apply-availability"][0]
    assert av["samples"] == 15


def test_cli_rc0_on_a_clean_port_rollout_trace(tmp_path):
    """The port's own client, a clean full-bundle rollout: every
    availability sample is good."""
    tel = telemetry.Telemetry()
    with FakeApiServer(auto_ready=True) as api:
        client = kubeapply.Client(api.url, telemetry=tel)
        kubeapply.apply_groups(
            client, manifests.rollout_groups(specmod.default_spec()),
            wait=True, stage_timeout=60, poll=0.02, max_inflight=8,
            watch_ready=True)
        client.close()
    trace = tmp_path / "clean.json"
    tel.write_trace(str(trace))
    proc = run_port_cli("slo", "check", trace, "--json")
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    doc = json.loads(proc.stdout)
    assert doc["ok"] is True
    samples = {s["name"]: s["samples"] for s in doc["slos"]}
    assert set(samples) == {"apply-availability", "watch-uptime",
                            "admission-latency"}
    assert samples["apply-availability"] > 0
    assert doc == ref_slo.evaluate([ref_slo.load_trace(str(trace))]).to_dict()
