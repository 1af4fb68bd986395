"""The port's metrics textfile writer (``workloads/runtime_metrics.py``)
against the reference's: ``collect_lines`` line for line on the CPU with
the same sampler state, the writer's atomicity and path ladder, both
samplers' window semantics, the HBM ladder and the tensorcore gauge on
a (monkeypatched) H100, and ``burnin.run``'s publication."""

import os
import time
import types

import jax
import pytest
import torch

from tpu_cluster.workloads import runtime_metrics as ref
from tpu_cluster_torch.workloads import burnin, smoke
from tpu_cluster_torch.workloads import runtime_metrics as port

T = 1000.0  # the frozen monotonic clock of the parity cases


def _freeze_clock(monkeypatch, *mods):
    """Both writers read monotonic time T (wall time stays real)."""
    frozen = types.SimpleNamespace(monotonic=lambda: T, time=time.time)
    for mod in mods:
        monkeypatch.setattr(mod, "time", frozen)


@pytest.fixture
def one_cpu_device(monkeypatch):
    """The reference on one JAX CPU device (the test session runs a
    virtual 8-device mesh), the port on the CPU; no accelerator override;
    the monotonic clock frozen at T so both samplers read one instant."""
    cpu0 = jax.local_devices()[:1]
    monkeypatch.setattr(jax, "local_devices", lambda: cpu0)
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    _freeze_clock(monkeypatch, ref, port)


# (busy seconds ending at T - 5, FLOPs at T - 5, TPU_METRICS_WINDOW_S)
STATES = {
    "no_windows": None,
    "idle_windows": (0.0, 0.0, None),
    "busy": (3.0, 0.0, None),
    "busy_and_flops": (4.5, 2e12, None),
    "busy_short_window": (2.0, 1e9, "10"),
    "busy_long_ago": (1.0, 1e9, "2"),
}


@pytest.mark.parametrize("state", STATES.values(), ids=list(STATES))
def test_collect_lines_equals_reference_line_for_line(state, one_cpu_device,
                                                      monkeypatch):
    def lines(mod):
        if state is None:
            return mod.collect_lines(now=1234)
        busy, flops, window = state
        if window is not None:
            monkeypatch.setenv("TPU_METRICS_WINDOW_S", window)
        with mod.duty_cycle_window() as duty, \
                mod.tensorcore_window() as tc:
            duty._acc._t0 = tc._acc._t0 = T - 30
            duty.add_busy(busy, now=T - 5)
            tc.add_flops(flops, now=T - 5)
            return mod.collect_lines(now=1234)

    got, want = lines(port), lines(ref)
    assert got == want
    measured = state is not None and state[0] > 0
    assert any(line.startswith('tpu_duty_cycle_percent{chip="0"}')
               for line in got) == measured
    assert 'tpu_hbm_source{source="memory_stats"} 1' in got
    assert "tpu_process_devices 1" in got
    assert not any(line.startswith(("tpu_hbm_used_bytes{",
                                    "tpu_tensorcore_utilization_percent"))
                   for line in got)


def test_family_names_match_reference():
    assert port.DUTY_CYCLE_PERCENT == ref.DUTY_CYCLE_PERCENT
    assert port.TENSORCORE_UTILIZATION_PERCENT == \
        ref.TENSORCORE_UTILIZATION_PERCENT
    assert (port.DEFAULT_PATH, port.DEFAULT_DIR) == \
        (ref.DEFAULT_PATH, ref.DEFAULT_DIR)


def test_writer_atomic_and_prefixed(tmp_path):
    path = str(tmp_path / "metrics.prom")
    assert port.write(path, now=1234567890) == path
    text = open(path).read()
    assert "tpu_process_devices 1" in text
    assert "tpu_runtime_metrics_timestamp_seconds 1234567890" in text
    for line in text.splitlines():
        assert line.startswith("#") or line.startswith("tpu_"), line
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_writer_noop_without_directory(tmp_path):
    assert port.write(str(tmp_path / "nodir" / "m.prom")) is None


def test_writer_never_raises(tmp_path, monkeypatch):
    def broken(now=None):
        raise RuntimeError("device enumeration failed")

    monkeypatch.setattr(port, "collect_lines", broken)
    assert port.write(str(tmp_path / "m.prom")) is None
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("mod", [ref, port], ids=["reference", "port"])
def test_resolved_path_ladder(mod, tmp_path, monkeypatch):
    """TPU_METRICS_FILE wins; else a per-writer file in the drop-dir
    (created under the exporter hostPath); else the legacy path."""
    monkeypatch.delenv("TPU_METRICS_FILE", raising=False)
    monkeypatch.setattr(mod, "DEFAULT_DIR",
                        str(tmp_path / "run-tpu" / "metrics.d"))
    monkeypatch.setattr(mod, "DEFAULT_PATH",
                        str(tmp_path / "run-tpu" / "metrics.prom"))
    assert mod.resolved_path() == str(tmp_path / "run-tpu" / "metrics.prom")
    (tmp_path / "run-tpu").mkdir()
    path = mod.resolved_path()
    assert path == os.path.join(str(tmp_path / "run-tpu" / "metrics.d"),
                                f"{mod.writer_id()}.prom")
    assert path.endswith(f"-{os.getpid()}.prom")
    monkeypatch.setenv("TPU_METRICS_FILE", "/custom/m.prom")
    assert mod.resolved_path() == "/custom/m.prom"


def test_writer_id_matches_reference():
    assert port.writer_id() == ref.writer_id()


@pytest.mark.parametrize("mod", [ref, port], ids=["reference", "port"])
def test_duty_cycle_sampler_window_semantics(mod):
    s = mod.DutyCycleSampler(window_s=60)
    t0 = s._t0
    assert s.percent(now=t0 + 1) is None      # nothing marked busy yet
    s.add_busy(5, now=t0 + 10)                # busy during [5s, 10s]
    assert abs(s.percent(now=t0 + 10) - 50.0) < 1e-6
    assert s.percent(now=t0 + 200) == 0.0     # slid out: measured idle
    s2 = mod.DutyCycleSampler(window_s=60)
    s2.add_busy(1e9, now=s2._t0 + 1)
    assert s2.percent(now=s2._t0 + 1) == 100.0
    s3 = mod.DutyCycleSampler(window_s=60)
    s3.add_busy(40, now=s3._t0 + 40)          # busy [0s, 40s]
    assert abs(s3.percent(now=s3._t0 + 80) - 100.0 * 20 / 60) < 1e-6


@pytest.mark.parametrize("mod", [ref, port], ids=["reference", "port"])
def test_tensorcore_sampler_window_semantics(mod):
    s = mod.TensorcoreSampler(window_s=60)
    t0 = s._t0
    assert s.percent(8, 197.0, now=t0 + 1) is None
    s.add_flops(197.0e12, now=t0 + 10)
    assert abs(s.percent(1, 197.0, now=t0 + 10) - 10.0) < 1e-6
    assert s.percent(1, 197.0, now=t0 + 200) == 0.0
    assert s.percent(0, 197.0, now=t0 + 10) is None
    s.add_flops(1e30, now=t0 + 10)
    assert s.percent(1, 197.0, now=t0 + 10) == 100.0


def test_busy_reported_from_elsewhere_lands_in_the_window():
    port.add_busy(1.0)  # no window: a no-op
    with port.duty_cycle_window() as duty:
        port.add_busy(0.25)
        port.add_busy(0.5)
    assert duty.total_busy_s == 0.75


H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fake_h100(monkeypatch):
    """torch.cuda reporting one H100 whose allocator holds 4096 bytes of
    its 85,017,493,504 (what mem_get_info reads on that card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d=None: {"allocated_bytes.all.current": 4096})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (1 << 30, 85017493504))
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    _freeze_clock(monkeypatch, port)


def _gauges(lines):
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in lines if not line.startswith("#")}


def test_hbm_gauges_from_the_runtime_on_a_card(fake_h100):
    g = _gauges(port.collect_lines(now=1))
    assert g['tpu_hbm_used_bytes{chip="0"}'] == 4096
    assert g['tpu_hbm_limit_bytes{chip="0"}'] == 85017493504
    assert g['tpu_hbm_source{source="memory_stats"}'] == 1


def test_hbm_limit_falls_back_to_the_catalogue(fake_h100, monkeypatch):
    def no_info(d=None):
        raise RuntimeError("cudaMemGetInfo failed")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_info)
    g = _gauges(port.collect_lines(now=1))
    assert g['tpu_hbm_limit_bytes{chip="0"}'] == 80 << 30
    assert g['tpu_hbm_source{source="catalogue"}'] == 1
    # an unknown card and no override: the double miss, nothing invented
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA B200")
    lines = port.collect_lines(now=1)
    assert 'tpu_hbm_source{source="none"} 1' in lines
    assert not any(l.startswith(("tpu_hbm_limit_bytes{", "tpu_hbm_used"))
                   for l in lines)
    # the Allocate-injected override names the card instead
    monkeypatch.setenv("TPU_ACCELERATOR_TYPE", "H100-SXM5-80GB")
    assert 'tpu_hbm_source{source="catalogue"} 1' in \
        port.collect_lines(now=1)


def test_tensorcore_gauge_against_the_catalogue_peak(fake_h100):
    """989 TFLOP/s data-sheet peak: 2.967e15 FLOPs over a 30 s window is
    98.9 TFLOP/s, 10% of it; the duty cycle is published beside it."""
    with port.duty_cycle_window() as duty, \
            port.tensorcore_window() as tc:
        duty._acc._t0 = tc._acc._t0 = T - 30
        duty.add_busy(6.0, now=T - 1)
        tc.add_flops(2.967e15, now=T - 1)
        g = _gauges(port.collect_lines(now=1))
    assert g['tpu_tensorcore_utilization_percent{chip="0"}'] == \
        pytest.approx(10.0)
    assert g['tpu_duty_cycle_percent{chip="0"}'] == pytest.approx(20.0)
    assert g["tpu_process_devices"] == 1


def test_a_process_publishes_the_card_it_owns(fake_h100, monkeypatch):
    """Four H100s on the host, this process on card 2 (one rank a card):
    every gauge carries chip 2 alone, the tensorcore percentage is not
    divided by the card count, and only card 2's memory is read."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    asked = []

    def mem_get_info(d=None):
        asked.append(d)
        return (1 << 30, 85017493504)

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    with port.duty_cycle_window() as duty, \
            port.tensorcore_window() as tc:
        duty._acc._t0 = tc._acc._t0 = T - 30
        duty.add_busy(6.0, now=T - 1)
        tc.add_flops(2.967e15, now=T - 1)
        lines = port.collect_lines(now=1)
    g = _gauges(lines)
    chips = {key.split('chip="', 1)[1].split('"', 1)[0]
             for key in g if 'chip="' in key}
    assert chips == {"2"}
    assert g['tpu_tensorcore_utilization_percent{chip="2"}'] == \
        pytest.approx(10.0)
    assert g['tpu_duty_cycle_percent{chip="2"}'] == pytest.approx(20.0)
    assert g['tpu_hbm_limit_bytes{chip="2"}'] == 85017493504
    assert g["tpu_process_devices"] == 1
    assert asked == [torch.device("cuda", 2)]


def test_tensorcore_gauge_absent_off_catalogue(fake_h100, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA B200")
    with port.tensorcore_window() as tc:
        tc.add_flops(1e12, now=T - 1)
        lines = port.collect_lines(now=1)
    assert not any(port.TENSORCORE_UTILIZATION_PERCENT in l for l in lines)


def test_device_report_names_the_card(fake_h100):
    rep = smoke.device_report("cuda")
    assert rep["platform"] == "gpu" and rep["device_count"] == 1
    assert rep["devices"] == [{"id": 0, "kind": H100, "process": 0,
                               "hbm_bytes_limit": 85017493504,
                               "hbm_bytes_in_use": 4096}]


def test_burnin_run_publishes_mid_run(tmp_path, monkeypatch):
    """With interval 0 the run writes after every step and once at the
    end; the file carries the duty gauge of the run."""
    path = tmp_path / "m.prom"
    monkeypatch.setenv("TPU_METRICS_FILE", str(path))
    writes = []
    real_write = port.write

    def counting_write(p, now=None):
        writes.append(p)
        return real_write(p, now)

    monkeypatch.setattr(port, "write", counting_write)
    with port.duty_cycle_window():
        r = burnin.run(steps=3, device="cpu", publish_interval_s=0.0)
    assert r["ok"], r
    assert writes == [str(path)] * 4
    text = path.read_text()
    assert "tpu_duty_cycle_percent{" in text
    assert "tpu_process_devices 1" in text


def test_burnin_run_reports_flops(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_METRICS_FILE", str(tmp_path / "m.prom"))
    cfg = burnin.BurninConfig()
    with port.tensorcore_window() as tc:
        r = burnin.run(steps=3, cfg=cfg, device="cpu")
    assert r["ok"], r
    assert tc._total_flops == 3 * burnin.flops_per_step(cfg)
