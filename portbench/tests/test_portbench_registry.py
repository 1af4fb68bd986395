"""Every cell, configuration, traffic mix, driver and metric of
``BENCHMARK.json`` is a file of its own, found by its name, and the file
keeps to the benchmark's contract (``harness.contract_problems``); the
contract takes a cell of another architecture, with a driver of its own,
as new files and entries, and still refuses each broken case."""

from __future__ import annotations

import copy
import types

import pytest

from portbench import harness

DOC = harness.load_json(harness.BENCHMARK)
DRIVERS = sorted(p.stem for p in (harness.HERE / "drivers").glob("*.py")
                 if p.stem != "__init__")


def test_benchmark_keeps_its_contract():
    assert harness.contract_problems(DOC) == []


@pytest.mark.parametrize("name", DRIVERS)
def test_each_driver_declares_its_contract(name):
    drv = harness.driver_module(name)
    assert callable(drv.run) and callable(drv.calibration)
    assert isinstance(drv.COMPARED, frozenset) and drv.COMPARED
    assert callable(drv.check_model)


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    drv = harness.driver(c)
    assert set(c.limits) == drv.COMPARED
    drv.check_model(c.model)


# ------------------------------------------- a cell of another architecture

# GQA at Mellum2-12B-A2.5B's widths (d_model 2304 != 32 heads x 128), its
# sparse experts, one period of its layer pattern.
GQA_MOE = {"d_model": 2304, "n_heads": 32, "n_kv_heads": 4, "d_head": 128,
           "d_expert": 896, "n_experts": 64, "top_k": 8, "vocab": 98304,
           "context": 131072, "layers": 4}
CONFIG_FILE = "portbench/configs/moe-gqa.json"
CELL = "moe-gqa-train-s8192"
FILES = {
    CONFIG_FILE: {"name": "moe-gqa", "model": GQA_MOE,
                  "reduced": {"num_hidden_layers": "28 -> 4: one period"}},
    f"portbench/workloads/{CELL}.json": {
        "config": "moe-gqa", "traffic": "train-b2-s8192", "driver": "moe_train",
        "chips": 1, "limits": {"loss_gap": 1e-4, "grad_gap": 2e-3,
                               "change_gap": 2e-3, "dropped_tokens": 0.0}},
    "portbench/traffic/train-b2-s8192.json": {"kind": "train", "batch": 2,
                                              "seq": 8192},
}


def _moe_check(model):
    if model["n_heads"] % model["n_kv_heads"]:
        raise ValueError("query heads do not group over the key heads")
    if model["d_head"] not in (128, 256):
        raise ValueError(f"d_head {model['d_head']}")


MOE_DRIVER = types.SimpleNamespace(
    __name__="moe_train", run=lambda *a: None, calibration=lambda *a: None,
    COMPARED=frozenset({"loss_gap", "grad_gap", "change_gap",
                        "dropped_tokens"}),
    check_model=_moe_check)


def _synthetic():
    """``BENCHMARK.json`` with the GQA/MoE configuration and its training
    cell added as new files and entries, and its own driver."""
    doc = copy.deepcopy(DOC)
    files = copy.deepcopy(FILES)
    doc["configs"].append({"name": "moe-gqa", "source": "https://huggingface."
                           "co/JetBrains/Mellum2-12B-A2.5B-Instruct",
                           "file": CONFIG_FILE,
                           "reduced": ["num_hidden_layers"],
                           "why": "GQA, sparse experts"})
    doc["workloads"].append({"name": CELL, "config": "moe-gqa",
                             "traffic": "train-b2-s8192", "chips": 1,
                             "why": "one period at b2 x s8192"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if m["name"] in ("train_tokens_per_s", "train_mfu"):
            m["workloads"].append(CELL)
    return doc, files


def _limits_differ(doc, files):
    del files[f"portbench/workloads/{CELL}.json"]["limits"]["dropped_tokens"]


def _burnin_driver_on_gqa(doc, files):
    files[f"portbench/workloads/{CELL}.json"]["driver"] = "train"
    files[f"portbench/workloads/{CELL}.json"]["limits"].pop("dropped_tokens")


def _reduced_width(doc, files):
    doc["configs"][-1]["reduced"].append("head_dim")
    files[CONFIG_FILE]["reduced"]["head_dim"] = "128 -> 64"


def _short_context(doc, files):
    files[CONFIG_FILE]["model"]["context"] = 4096


def _two_layer_texts(doc, files):
    doc["per_layer"].append(dict(
        next(m for m in doc["per_layer"] if m["name"] == "train_mfu"),
        name="train_mfu.moe", layer="experts (another text)",
        workloads=[CELL]))


@pytest.mark.parametrize("broken, says", [
    (None, None),
    (_limits_differ, "limits"),
    (_burnin_driver_on_gqa, "refuses it"),
    (_reduced_width, "width"),
    (_short_context, "context"),
    (_two_layer_texts, "layer texts"),
], ids=["accepted", "limits_differ_from_compared", "burnin_d_model",
        "reduced_dim", "context_under_seq", "two_layer_texts"])
def test_a_new_architecture_joins_as_new_files(broken, says, monkeypatch):
    doc, files = _synthetic()
    if broken is not None:
        broken(doc, files)
    if broken is _two_layer_texts:
        # the extra metric's reader: the one of its prefix
        real = harness.reader
        monkeypatch.setattr(harness, "reader", lambda name: real(
            "train_mfu" if name == "train_mfu.moe" else name))

    def read(rel):
        return files[rel] if rel in files else harness.load_json(
            harness.ROOT / rel)
    problems = harness.contract_problems(doc, read,
                                         {"moe_train": MOE_DRIVER})
    if says is None:
        assert problems == []
    else:
        assert problems and all(CELL in p or "moe-gqa" in p
                                or "train_mfu" in p for p in problems), \
            problems
        assert any(says in p for p in problems), problems
