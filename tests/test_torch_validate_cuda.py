"""The validation Job's entry point and the metrics writer on the card:
device-query, the suite, the HBM gauges and the tensorcore gauge.

They need a card, so they skip on a host without one. This file imports
torch and the port only, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_validate_cuda.py``
from the repository root.
"""

import json

import pytest
import torch

from tpu_cluster_torch import topology
from tpu_cluster_torch.workloads import runtime_metrics, smoke, validate


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _gauges(lines):
    out = {}
    for line in lines:
        if not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


@pytest.mark.cuda
def test_device_query_reports_every_card(capsys, tmp_path, monkeypatch):
    _card()
    monkeypatch.setenv("TPU_METRICS_FILE", str(tmp_path / "m.prom"))
    n = torch.cuda.device_count()
    rc = validate.main(["--mode=device-query", f"--expect-devices={n}"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"], doc
    assert doc["platform"] == "gpu" and doc["local_device_count"] == n
    assert [d["kind"] for d in doc["devices"]] == [
        torch.cuda.get_device_name(i) for i in range(n)]
    assert all(d["hbm_bytes_limit"] == torch.cuda.mem_get_info(i)[1]
               for i, d in enumerate(doc["devices"]))
    # a short device count fails the check
    rc = validate.main(["--mode=device-query", f"--expect-devices={n + 1}"])
    assert rc == 1 and not json.loads(capsys.readouterr().out)["ok"]


@pytest.mark.cuda
def test_suite_on_the_card(capsys, tmp_path, monkeypatch):
    _card()
    monkeypatch.setenv("TPU_METRICS_FILE", str(tmp_path / "m.prom"))
    rc = validate.main(["--mode=suite", "--matmul-dim=1024"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"], doc
    assert doc["matmul"]["tflops"] > 0 and doc["vector_add"]["ok"]
    assert doc["psum"]["devices"] == torch.cuda.device_count()
    assert doc["metrics_file"] == str(tmp_path / "m.prom")


@pytest.mark.cuda
def test_hbm_gauges_from_the_allocator_and_mem_get_info():
    dev = _card()
    held = torch.empty(1 << 20, device=dev)  # keep bytes in use
    gauges = _gauges(runtime_metrics.collect_lines(now=1))
    assert gauges['tpu_hbm_used_bytes{chip="0"}'] >= held.numel() * 4
    assert gauges['tpu_hbm_limit_bytes{chip="0"}'] == \
        torch.cuda.mem_get_info(0)[1]
    assert gauges['tpu_hbm_source{source="memory_stats"}'] == 1
    # the process's own card, however many the host has
    assert gauges["tpu_process_devices"] == 1
    del held


@pytest.mark.cuda
def test_tensorcore_gauge_from_a_matmul(monkeypatch):
    dev = _card()
    if topology.from_device_name(torch.cuda.get_device_name(dev)) is None:
        pytest.skip("card not in the catalogue: no peak, no gauge")
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    with runtime_metrics.duty_cycle_window(), \
            runtime_metrics.tensorcore_window():
        smoke.matmul(2048, 2048, 2048, device=dev)
        gauges = _gauges(runtime_metrics.collect_lines())
    tc = gauges['tpu_tensorcore_utilization_percent{chip="0"}']
    assert 0 < tc <= 100
    assert gauges['tpu_duty_cycle_percent{chip="0"}'] > 0
