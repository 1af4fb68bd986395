"""Every cell, configuration, traffic mix, driver and metric of
``BENCHMARK.json`` is a file of its own, found by its name, and the file
keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness, trace

DOC = harness.load_json(harness.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in DOC["workloads"]]
METRICS = DOC["end_to_end"] + DOC["per_layer"]
COMPARED = {"train": {"loss_gap", "grad_gap", "change_gap"},
            "serve_open": {"served_gap", "unanswered"},
            "serve_saturated": {"served_gap", "unanswered"}}


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in DOC["command"])
    assert 1 <= DOC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in DOC["workloads"] if w["name"] == cell)
    c = harness.load_cell(cell)
    assert c.spec["config"] == entry["config"]
    assert c.spec["traffic"] == entry["traffic"]
    assert c.chips == entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert callable(harness.driver(c).run)
    assert set(c.limits) == COMPARED[c.spec["driver"]]


@pytest.mark.parametrize("config", DOC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    doc = harness.load_json(harness.ROOT / config["file"])
    assert doc["name"] == config["name"]
    assert config["file"].startswith("portbench/configs/")
    assert sorted(doc["reduced"]) == sorted(config["reduced"])
    for key in config["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank"))
    m = doc["model"]
    assert m["d_model"] == m["n_heads"] * m["d_head"]
    assert m["context"] >= max(
        harness.load_cell(w["name"]).traffic.get("seq", 0)
        for w in DOC["workloads"] if w["config"] == config["name"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]))
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


def test_names_unique_and_valid():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in DOC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for w in DOC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_bounds_and_sources():
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "bound" not in m


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    e2e = {m["name"] for m in harness.benchmark_metrics(cell, "end_to_end")}
    layer = harness.benchmark_metrics(cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e


def test_per_layer_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in DOC["end_to_end"]}
    layers = {}
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("group", ["attn_fwd", "attn_bwd"])
def test_kernel_names_are_the_ports_kernels(group):
    names = trace.kernel_names(group)
    assert names
    sources = "".join(p.read_text() for p in
                      (harness.ROOT / "tpu_cluster_torch" / "csrc").glob("*.cu"))
    for name in names:
        assert re.search(r"__global__.{0,200}?\b" + name + r"\(", sources,
                         re.S), name


@pytest.mark.parametrize("cell", CELLS)
def test_serving_mix_names_its_source(cell):
    """A serving mix cites the public workload its lengths come from, and
    lists what it set itself and each clip it makes."""
    mix = harness.load_cell(cell).traffic
    if mix["kind"] == "train":
        return
    assert mix["source"] and len(mix["source"]) <= 200
    assert mix["assumed"]
    assert {"prompt.max", "output.max"} <= set(mix["reduced"])


def test_benchmark_file_is_small():
    assert len(json.dumps(DOC)) < 64 * 1024
