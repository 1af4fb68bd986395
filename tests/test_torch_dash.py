"""The port's live-SLO and dashboard layers (``tpu_cluster_torch.
metricsdb``: ``live_slo_report``, ``sparkline``, ``render_dash``) against
the reference's, and the port's ``slo check --live`` and ``dash`` CLIs.

Compared exactly: ``render_dash`` of ``TSDB.load`` of the checked-in
``dash_tsdb.json`` equals ``dash_golden.txt`` byte for byte (in process
and through ``dash --once --replay`` with PyYAML blocked), and equals
the reference's frame at other windows and clocks; ``live_slo_report``
over the same dump gives the reference's ``to_dict()``; over one chaos
soak, the live (scraped) and trace-derived verdicts burn the same window
pairs. The CLIs keep the reference's rcs (0 healthy, 1 burning, 2 bad
invocation)."""

import io
import json
import threading
import time
from contextlib import redirect_stderr, redirect_stdout

import pytest

from fake_apiserver import FakeApiServer, standard_fault_script
from torch_apply_helpers import FIXTURES, no_nagle, run_port_cli  # noqa: F401
from tpu_cluster import metricsdb as ref_metricsdb
from tpu_cluster import slo as ref_slo
from tpu_cluster_torch import kubeapply, metricsdb, slo, telemetry
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch.__main__ import main as cli_main
from tpu_cluster_torch.render import manifests

DASH_TSDB = f"{FIXTURES}/dash_tsdb.json"
DASH_GOLDEN = f"{FIXTURES}/dash_golden.txt"
FAST_RETRY = kubeapply.RetryPolicy(attempts=8, base_s=0.02, cap_s=0.3)


def _dump():
    with open(DASH_TSDB, encoding="utf-8") as f:
        return json.load(f)


def _golden():
    with open(DASH_GOLDEN, encoding="utf-8") as f:
        return f.read()


def test_replayed_frame_equals_the_golden_text():
    assert metricsdb.render_dash(metricsdb.TSDB.load(_dump())) + "\n" == \
        _golden()
    proc = run_port_cli("dash", "--once", "--replay", DASH_TSDB)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _golden()


@pytest.mark.parametrize("window_s", [5.0, 30.0, 60.0, 600.0])
@pytest.mark.parametrize("back_s", [0.0, 7.5])
def test_frame_equals_the_reference_at_other_windows(window_s, back_s):
    port = metricsdb.TSDB.load(_dump())
    ref = ref_metricsdb.TSDB.load(_dump())
    now = port.now() - back_s
    assert metricsdb.render_dash(port, window_s=window_s, now=now) == \
        ref_metricsdb.render_dash(ref, window_s=window_s, now=now)


def test_serving_panel_equals_the_reference():
    """A TSDB holding the serving families: the tok/s sparkline, the
    queue depth and the autoscaler's replicas row."""
    frames = []
    for mod in (ref_metricsdb, metricsdb):
        clock = [1000.0]
        tsdb = mod.TSDB(clock=lambda: clock[0])
        for i in range(40):
            clock[0] = 1000.0 + i * 0.5
            for job, rate in (("serving-0", 120.0), ("serving-1", 40.0)):
                tsdb.append("up", {"job": job}, 1.0)
                tsdb.append(telemetry.SERVING_TOKENS_TOTAL,
                            {"job": job}, rate * i * 0.5, mtype="counter")
                tsdb.append(telemetry.SERVING_QUEUE_DEPTH, {"job": job},
                            float(i % 3))
            tsdb.append(telemetry.AUTOSCALE_REPLICAS, {"job": "tpuctl"},
                        1.0 if i < 20 else 2.0)
        frames.append(mod.render_dash(tsdb, window_s=5.0))
    assert frames[1] == frames[0]
    assert "replicas 2" in frames[1]
    assert "tok/s 160.0" in frames[1]


@pytest.mark.parametrize("values", [[], [0.0, 0.0], [1.0, 2.0, 8.0],
                                    [-1.0, 3.0, 0.5], [5.0]])
def test_sparkline_equals_the_reference(values):
    assert metricsdb.sparkline(values) == ref_metricsdb.sparkline(values)


def test_live_slo_report_over_the_dump_equals_the_reference():
    port = metricsdb.live_slo_report(metricsdb.TSDB.load(_dump()))
    ref = ref_metricsdb.live_slo_report(ref_metricsdb.TSDB.load(_dump()))
    assert port.to_dict() == ref.to_dict()
    assert slo.format_report(port) == ref_slo.format_report(ref)


def test_live_and_trace_derived_slo_reach_the_same_verdict():
    """One chaos soak of the port's client, judged from its span tree
    and from counters its ``ScrapeManager`` scraped off the fake's
    ``/__fake_metrics``: the same window pairs burn."""
    tel = telemetry.Telemetry()
    tsdb = metricsdb.TSDB()
    with FakeApiServer(auto_ready=True,
                       chaos=standard_fault_script(0.05)) as api:
        manager = metricsdb.ScrapeManager(
            [metricsdb.Target("fake", api.url + "/__fake_metrics")],
            tsdb, interval_s=0.03)
        manager.start()
        time.sleep(0.05)
        client = kubeapply.Client(api.url, telemetry=tel,
                                  retry=FAST_RETRY)
        kubeapply.apply_groups(
            client, manifests.rollout_groups(specmod.default_spec()),
            wait=True, stage_timeout=60, poll=0.02, max_inflight=8)
        client.close()
        time.sleep(0.1)
        manager.stop()

    trace_report = slo.evaluate([tel.chrome_trace()])
    live_report = metricsdb.live_slo_report(tsdb)

    def burning_pairs(report):
        return {(v.slo.name, w.severity) for v in report.verdicts
                for w in v.windows if w.burning}

    assert trace_report.ok == live_report.ok
    assert burning_pairs(trace_report) == burning_pairs(live_report) == \
        {("apply-availability", "warn")}
    live_watch = [v for v in live_report.verdicts
                  if v.slo.name == "watch-uptime"][0]
    assert live_watch.total_samples == 0 and not live_watch.burning


def _run_live(api_url):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli_main(["slo", "check", "--live", "--targets",
                       f"fake={api_url}/__fake_metrics", "--duration",
                       "0.6", "--scrape-interval", "0.1", "--json"])
    return rc, json.loads(out.getvalue())


def _drive(client, stop):
    while not stop.is_set():
        client.get("/api/v1/namespaces/default/configmaps/probe")
        time.sleep(0.02)


@pytest.mark.parametrize("chaos,want_rc", [
    (None, 0), ([{"status": 503, "match": "/api/"}], 1)])
def test_slo_check_live_rc0_clean_rc1_on_a_503_burst(chaos, want_rc):
    with FakeApiServer(auto_ready=True, chaos=chaos) as api:
        client = kubeapply.Client(api.url, retry=kubeapply.NO_RETRY)
        stop = threading.Event()
        t = threading.Thread(target=_drive, args=(client, stop),
                             daemon=True)
        t.start()
        rc, doc = _run_live(api.url)
        stop.set()
        t.join(timeout=10)
        client.close()
    assert rc == want_rc and doc["ok"] is (want_rc == 0), doc
    burning = [s["name"] for s in doc["slos"] if s["burning"]]
    assert burning == ([] if want_rc == 0 else ["apply-availability"])


def test_slo_check_live_all_targets_down_notes_and_stays_rc0():
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli_main(["slo", "check", "--live", "--targets",
                       "dead=http://127.0.0.1:1/metrics", "--duration",
                       "0.2", "--scrape-interval", "0.05"])
    assert rc == 0
    assert "target dead is down" in err.getvalue()
    assert "no samples" in out.getvalue()


def test_dash_once_against_the_fake():
    with FakeApiServer(auto_ready=True) as api:
        client = kubeapply.Client(api.url)
        client.apply({"apiVersion": "v1", "kind": "ConfigMap",
                      "metadata": {"name": "d", "namespace": "default"}})
        out = io.StringIO()
        with redirect_stdout(out):
            rc = cli_main(["dash", "--once", "--interval", "0.1",
                           "--targets", f"fake={api.url}/__fake_metrics"])
        client.close()
    frame = out.getvalue()
    assert rc == 0
    assert frame.startswith("tpuctl dash — 1 target(s), window 60s\n")
    assert " 1 " in frame.splitlines()[2]


@pytest.mark.parametrize("argv,body", [
    (["slo", "check", "--live"], None),
    (["slo", "check"], None),
    (["slo", "check", "--targets", "a=http://x/m"], None),
    (["slo", "check", "--live", "--targets", "notaurl"], None),
    (["slo", "check", "--live", "--targets", "a=http://x/m", "t.json"],
     None),
    (["dash", "--once"], None),
    (["dash", "--once", "--targets", "a=http://127.0.0.1:1/m",
      "--targets", "a=http://127.0.0.1:2/m"], None),
    (["dash", "--replay", "DUMP"], '{"not": "a dump"}'),
    (["dash", "--replay", "DUMP"], "[]"),
    (["dash", "--replay", "DUMP"],
     '{"series": [{"name": "x", "samples": [[null, 1]]}]}'),
    (["dash", "--replay", "ABSENT"], None),
])
def test_invalid_invocations_are_rc2(tmp_path, argv, body):
    dump = tmp_path / "dump.json"
    if body is not None:
        dump.write_text(body)
    argv = [str(dump) if a == "DUMP" else
            str(tmp_path / "absent.json") if a == "ABSENT" else a
            for a in argv]
    with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()):
        assert cli_main(argv) == 2
