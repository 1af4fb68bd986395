"""The port's scrape pipeline (``tpu_cluster_torch.metricsdb``: parser,
TSDB, scraper) against the reference's (``tpu_cluster/metricsdb.py``).

What is compared, exactly unless a test says otherwise:
- the render/parse round trip on the port's registry,
  ``parse_text(reg.render()).samples == reg.samples()``, with hostile
  label bytes and a seeded fuzz of the escape alphabet;
- both packages' ``parse_text`` on the same texts (samples, types,
  helps, and the errors they raise);
- the TSDB's ``latest``/``window``/``increase``/``rate``/
  ``histogram_quantile``/``aggregate`` on the same appends and ingests
  under one injected clock, counter resets, staleness, retention, the
  zero baseline and exported-label renames included, and ``dump``/
  ``load`` round trips;
- ``ScrapeManager`` against the port's ``MetricsServer`` and against
  dead targets (``up`` 0, never raising), each scrape as the
  reference's manager sees it.
"""

import json
import random
import time

import pytest

from fake_apiserver import FakeApiServer
from tpu_cluster import metricsdb as ref_metricsdb
from tpu_cluster import telemetry as ref_telemetry
from tpu_cluster_torch import metricsdb, telemetry

SIDES = ((ref_metricsdb, ref_telemetry), (metricsdb, telemetry))

NASTY_LABELS = [
    'plain', 'with "quotes"', "back\\slash", "new\nline",
    'all\\three: "\\\n"', "\\n literal backslash-n", "trailing\\",
    "", "comma,brace{}=equals", "unicode ✓ ✗",
]


def both(fn):
    """``fn(metricsdb, telemetry)`` on the reference's modules, then the
    port's; asserts the two results are equal and returns the port's."""
    ref, port = (fn(*side) for side in SIDES)
    assert port == ref
    return port


def _nasty_registry(tel):
    reg = tel.MetricsRegistry()
    for i, value in enumerate(NASTY_LABELS):
        reg.counter("hostile_total", "hostile labels", label=value).inc(
            i + 1)
    reg.counter("bare_total", "no labels at all").inc(7)
    reg.gauge("a_gauge", "negative and fractional").set(-2.75)
    hist = reg.histogram("lat_seconds", "latency",
                         buckets=(0.001, 0.25, 4.0), who='h"i\n\\')
    for v in (0.0001, 0.1, 0.2, 1.0, 99.0):
        hist.observe(v)
    return reg


# ------------------------------------------------------------------ parser


def test_parse_render_round_trip_on_the_ports_registry():
    reg = _nasty_registry(telemetry)
    parsed = metricsdb.parse_text(reg.render())
    assert parsed.samples == reg.samples()
    assert parsed.types == {"hostile_total": "counter",
                            "bare_total": "counter", "a_gauge": "gauge",
                            "lat_seconds": "histogram"}
    inf_rows = [v for (name, pairs), v in parsed.samples.items()
                if name == "lat_seconds_bucket"
                and dict(pairs).get("le") == "+Inf"]
    assert inf_rows == [5.0]
    # the registries render the same text, and samples() agree
    ref = _nasty_registry(ref_telemetry)
    assert reg.render() == ref.render()
    assert reg.samples() == ref.samples()


def test_hostile_label_fuzz_round_trips_on_both():
    rng = random.Random(1337)
    alphabet = 'ab"\\\n{},= \t✓'
    values = ["".join(rng.choice(alphabet)
                      for _ in range(rng.randint(0, 24)))
              for _ in range(200)]

    def run(mdb, tel):
        reg = tel.MetricsRegistry()
        for i, value in enumerate(values):
            reg.counter("fuzz_total", "", v=value, i=str(i)).inc()
        parsed = mdb.parse_text(reg.render())
        return {dict(pairs)["i"]: dict(pairs)["v"]
                for (name, pairs) in parsed.samples if name == "fuzz_total"}

    assert both(run) == {str(i): v for i, v in enumerate(values)}
    for value in NASTY_LABELS + values + ["\\x", "\\"]:
        assert telemetry.unescape_label(value) == \
            ref_telemetry.unescape_label(value)
        assert telemetry.unescape_label(
            telemetry.escape_label(value)) == value
    for v in (0.0, 3.0, -2.75, 0.1 + 0.2, 1e20, 1 / 3):
        assert telemetry.fmt_value(v) == ref_telemetry.fmt_value(v)


TEXTS = {
    "comments_and_timestamps": ("# some free comment\n# TYPE x counter\n"
                                "x{a=\"b\"} 4 1700000000\n\ny 2.5\n"
                                "# HELP y a gauge\n"),
    "spaces_in_labels": 'm{ a = "1" , b="2",} 3\n',
    "no_name": "{no_name} 1",
    "unterminated": "x{unterminated=\"v} 1",
    "no_value": "x{a=\"b\"}",
    "bad_value": "x notanumber",
    "unquoted": "x{a=b} 1",
    "dangling_escape": 'x{a="\\',
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_text_agrees_with_the_reference(name):
    def run(mdb, _tel):
        try:
            p = mdb.parse_text(TEXTS[name])
        except ValueError as exc:
            return ["error", str(exc)]
        return [sorted(p.samples.items()), p.types, p.helps]

    both(run)


# -------------------------------------------------------------------- tsdb


def _clocked(mdb, **kwargs):
    clock = [0.0]
    return clock, mdb.TSDB(clock=lambda: clock[0], **kwargs)


def test_counter_reset_increase_and_rate():
    def run(mdb, _tel):
        clock, tsdb = _clocked(mdb)
        for ts, v in [(0, 100), (1, 120), (2, 5), (3, 15)]:
            clock[0] = float(ts)
            tsdb.append("c_total", {"job": "x"}, v, mtype="counter")
        return [tsdb.increase("c_total", 10), tsdb.rate("c_total", 10),
                tsdb.rate("c_total", 1.5), tsdb.family_type("c_total")]

    inc, rate, _short, mtype = both(run)
    assert inc == {(("job", "x"),): 35.0} and mtype == "counter"
    assert rate[(("job", "x"),)] == pytest.approx(35.0 / 3.0)


def test_staleness_retention_and_the_ring_bound():
    def run(mdb, _tel):
        clock, tsdb = _clocked(mdb, staleness_s=5.0, retention_s=10.0,
                               max_samples_per_series=8)
        out = []
        tsdb.append("up", {"job": "a"}, 1.0)
        clock[0] = 3.0
        out.append(tsdb.latest("up", job="a"))
        clock[0] = 6.0
        out.append(tsdb.latest("up", job="a"))
        scrape = mdb.ParsedScrape({("m", ()): 1.0}, {"m": "gauge"}, {})
        for ts in range(30):
            clock[0] = float(ts)
            tsdb.ingest(scrape)
        out += [tsdb.window("m", 1000.0), tsdb.series_names(),
                tsdb.span_s()]
        return out

    out = both(run)
    assert out[1] == {} and len(out[2][()]) <= 8


def test_zero_baseline_and_exported_label_renames():
    def run(mdb, _tel):
        clock, tsdb = _clocked(mdb)
        counter = {"t": "counter"}
        clock[0] = 1.0
        tsdb.ingest(mdb.ParsedScrape({("t", ()): 0.0}, counter, {}))
        clock[0] = 2.0
        tsdb.ingest(mdb.ParsedScrape(
            {("t", ()): 0.0, ("t", (("code", "503"),)): 3.0}, counter, {}),
            zero_baseline_ts=1.0)
        clock[0] = 3.0
        tsdb.ingest(mdb.ParsedScrape({("g", ()): 5.0}, {"g": "gauge"}, {}),
                    zero_baseline_ts=2.0)
        out = [tsdb.increase("t", 100.0, code="503"),
               tsdb.increase("g", 100.0)]
        clock2, tsdb2 = _clocked(mdb)
        for ts, a, b in ((1.0, 5000.0, 300.0), (2.0, 5100.0, 310.0)):
            clock2[0] = ts
            tsdb2.ingest(mdb.ParsedScrape(
                {("t", (("job", "fake"),)): a,
                 ("t", (("job", "self"),)): b}, counter, {}),
                labels={"job": "self"})
        out += [tsdb2.increase("t", 100.0), tsdb2.label_values("t", "job")]
        return out

    out = both(run)
    assert out[0] == {(("code", "503"),): 3.0} and out[1] == {}


def test_lookback_cap_windows_and_histogram_quantile():
    def run(mdb, _tel):
        clock, tsdb = _clocked(mdb, staleness_s=30.0, retention_s=1000.0)
        for ts, v in [(0.0, 100.0), (300.0, 700.0), (301.0, 705.0)]:
            clock[0] = ts
            tsdb.append("c_total", {}, v, mtype="counter")
        clock[0] = 302.0
        out = [tsdb.increase("c_total", 5.0),
               tsdb.increase("c_total", 1000.0),
               tsdb.window("c_total", 10.0, now=300.0)]
        for le, cum in [("0.1", 10.0), ("0.5", 90.0), ("1", 99.0),
                        ("+Inf", 100.0)]:
            tsdb.append("lat_seconds_bucket", {"le": le}, cum)
        out += [tsdb.histogram_quantile(q, "lat_seconds")
                for q in (0.05, 0.5, 0.95, 0.999)]
        out.append(tsdb.histogram_quantile(0.5, "absent"))
        values = {(("a", "1"),): 2.0, (("a", "2"),): 4.0}
        out += [mdb.aggregate(values, how) for how in ("sum", "avg", "max")]
        out.append(mdb.aggregate({}, "max"))
        try:
            mdb.aggregate(values, "median")
        except ValueError as exc:
            out.append(str(exc))
        return out

    out = both(run)
    assert out[0] == {(): 5.0} and out[1] == {(): 605.0}
    assert out[4] == pytest.approx(0.1 + 0.4 * (50 - 10) / (90 - 10))


def test_dump_load_round_trip_and_junk_documents():
    def run(mdb, _tel):
        clock, tsdb = _clocked(mdb, max_samples_per_series=5000)
        for ts in (1.0, 2.0, 3.0):
            clock[0] = ts
            tsdb.append("c_total", {"job": "x"}, ts * 10, mtype="counter")
        doc = json.loads(json.dumps(tsdb.dump()))
        loaded = mdb.TSDB.load(doc)
        assert loaded.dump() == tsdb.dump()
        out = [doc, loaded.now(), loaded.max_samples_per_series,
               loaded.family_type("c_total")]
        for junk in ({"not": "a dump"}, [], 7,
                     {"series": [{"name": "x", "samples": [[None, 1]]}]},
                     {"series": ["not a series"]}):
            try:
                mdb.TSDB.load(junk)
            except ValueError as exc:
                out.append(str(exc))
        return out

    out = both(run)
    assert out[1] == 3.0 and out[2] == 5000 and len(out) == 9


# ------------------------------------------------------------------ scrape


def _scrape_view(tsdb, job):
    """A scrape as the store holds it, without what is made of the
    clock (the duration's value)."""
    return {name: tsdb.latest(name, job=job)
            for name in tsdb.series_names()
            if name != "tpuctl_scrape_duration_seconds"}


def test_scrape_manager_against_the_ports_metrics_server():
    """Both managers scrape one MetricsServer of the port (counters,
    gauges and a histogram under hostile labels): equal stores, up 1,
    the self-metrics synthesized, and the served registry's samples
    under job=."""
    reg = _nasty_registry(telemetry)
    with metricsdb.MetricsServer(reg, 0) as server:
        def run(mdb, tel):
            tsdb = mdb.TSDB()
            t = tel.Telemetry()
            manager = mdb.ScrapeManager([mdb.Target("self", server.url)],
                                        tsdb, telemetry=t)
            results = [manager.scrape_once(), manager.scrape_once()]
            manager.stop()
            mirrored = sorted(line for line in t.metrics.render()
                              .splitlines() if line.startswith("up{"))
            return [results, manager.up_snapshot(), manager.scrapes(),
                    _scrape_view(tsdb, "self"), mirrored]

        out = both(run)
    assert out[1] == {"self": True}
    view = out[3]
    assert view["up"] == {(("job", "self"),): 1.0}
    assert view["bare_total"] == {(("job", "self"),): 7.0}
    assert view["tpuctl_scrape_samples_total"] == {
        (("job", "self"),): 2.0 * len(reg.samples())}


def test_dead_targets_read_up_zero_and_never_raise():
    """A refused port and a live server whose body is not exposition:
    up 0 for both, the loop thread stays healthy, nothing raises."""
    with FakeApiServer(auto_ready=True) as api:
        def run(mdb, _tel):
            tsdb = mdb.TSDB()
            manager = mdb.ScrapeManager(
                [mdb.Target("refused", "http://127.0.0.1:1/metrics"),
                 mdb.Target("garbled", api.url + "/api/v1/namespaces/x"
                            "/configmaps/none")],
                tsdb, interval_s=0.02, timeout_s=0.5)
            manager.start()
            deadline = time.monotonic() + 10
            while manager.scrapes() < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            healthy = manager.healthy()
            manager.stop()
            return [healthy, manager.up_snapshot(),
                    {job: mdb.aggregate(tsdb.latest("up", job=job), "max")
                     for job in ("refused", "garbled")},
                    manager.healthy()]

        assert both(run) == [True, {"refused": False, "garbled": False},
                             {"refused": 0.0, "garbled": 0.0}, False]


def test_target_grammar_and_duplicate_jobs():
    def run(mdb, _tel):
        out = []
        for call in (lambda: mdb.ScrapeManager(
                         [mdb.Target("a", "http://127.0.0.1:1/m"),
                          mdb.Target("a", "http://127.0.0.1:2/m")],
                         mdb.TSDB()),
                     lambda: mdb.parse_target("no-equals-url"),
                     lambda: mdb.Target("j", "ftp://nope/metrics")):
            try:
                call()
            except ValueError as exc:
                out.append(str(exc))
        t = mdb.parse_target("job=http://h:9/metrics?x=1")
        out.append([t.job, t.url, t.base_url, t.path])
        return out

    assert len(both(run)) == 4
