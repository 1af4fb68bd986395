"""Without a card the run fails and prints no result; so it does in a
checkout that holds only the benchmark."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ARGS = ["--workload", "mpt7b8k-train-s8192", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "portbench.run", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    proc = _run(harness.ROOT)
    _no_result(proc)
    assert "card" in proc.stderr or "CUDA" in proc.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(harness.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))


def test_port_missing_fails_even_with_a_card(monkeypatch):
    from portbench import run

    monkeypatch.setattr(harness, "require_card", lambda chips: None)
    monkeypatch.setitem(sys.modules, "tpu_cluster_torch", None)
    assert run.main(ARGS) != 0
