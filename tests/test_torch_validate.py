"""The port's validation-Job entry point (``workloads/validate.py``)
against the reference's on the CPU: every mode, with ``--device cpu``,
exits as the reference's does and prints the same JSON keys (values
that name the device aside); without a card and without ``--device
cpu`` it exits non-zero; ``burnin`` trains the sharded step over a process
group of two ranks."""

import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from tpu_cluster.workloads import validate as ref
from tpu_cluster_torch.workloads import collectives, validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DEVICES = len(jax.local_devices())  # the session's virtual mesh

# mode -> (arguments for both, the port's --expect-devices, the
# reference's): device-query passes when the count matches the device
# count of each side (1 CPU device for the port, the virtual mesh for
# the reference) and fails when it is one short
MODES = {
    "device-query": (["--mode=device-query"], 1, REF_DEVICES),
    "device-query-short": (["--mode=device-query"], 2, REF_DEVICES + 1),
    "vector-add": (["--mode=vector-add"], 0, 0),
    "matmul": (["--mode=matmul", "--matmul-dim=128"], 0, 0),
    "psum": (["--mode=psum"], 0, 0),
    "burnin": (["--mode=burnin"], 0, 0),
    "suite": (["--mode=suite", "--matmul-dim=128"], 0, 0),
}


def _main(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, json.loads(capsys.readouterr().out)


def _keys(doc):
    """The document's keys, and one level down for the nested documents
    (the suite's parts; bootstrap)."""
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in doc.items()}


@pytest.mark.parametrize("mode", MODES, ids=list(MODES))
def test_mode_matches_reference(mode, tmp_path, monkeypatch, capsys):
    args, port_expect, ref_expect = MODES[mode]
    monkeypatch.setenv("TPU_METRICS_FILE", str(tmp_path / "m.prom"))
    monkeypatch.delenv("TPU_DEVICE_COUNT", raising=False)
    got_rc, got = _main(validate, args + ["--device=cpu"] + (
        [f"--expect-devices={port_expect}"] if port_expect else []), capsys)
    want_rc, want = _main(ref, args + (
        [f"--expect-devices={ref_expect}"] if ref_expect else []), capsys)
    assert got_rc == want_rc == (1 if mode.endswith("short") else 0)
    assert _keys(got) == _keys(want)
    assert got["metrics_file"] == want["metrics_file"] == \
        str(tmp_path / "m.prom")
    assert got["bootstrap"] == want["bootstrap"]


def test_device_query_counts_the_cpu_as_one_device(capsys):
    rc, doc = _main(validate, ["--mode=device-query", "--device=cpu"],
                    capsys)
    assert rc == 0 and doc["platform"] == "cpu"
    assert (doc["local_device_count"], doc["expected_devices"]) == (1, 1)


def test_exits_nonzero_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert validate.main(["--mode=vector-add"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "--device cpu" in captured.err
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_cluster_torch.workloads.validate",
         "--mode=device-query"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_burnin_trains_a_process_group_of_two():
    """A group of two ranks is not refused: ``burnin`` trains the sharded
    step over it, on ``default_mesh_shape(2)``, and the loss falls."""
    doc = collectives.run_ranks(2, validate.run, "burnin", device="cpu")
    assert doc["ok"], doc
    assert doc["mesh"] == {"data": 1, "model": 2}
    assert doc["devices"] == doc["processes"] == 2
    assert doc["loss_decreasing"] and len(doc["losses"]) == 5
