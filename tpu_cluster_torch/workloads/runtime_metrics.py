"""Runtime-metrics textfile writer — the workload side of the scrape path,
the port's counterpart of ``tpu_cluster/workloads/runtime_metrics.py``.

The process that owns the cards writes ``tpu_``-prefixed Prometheus lines
to a hostPath textfile (``/run/tpu/metrics.d/<writer>.prom``, or the
legacy ``/run/tpu/metrics.prom``), and the tpu-metrics-exporter DaemonSet
relays validated lines into its ``/metrics`` endpoint. Family names,
HELP and TYPE text are the reference's byte for byte: the contract
registry (``tpu_cluster/contracts.py``) pins them, the exporter relays
them and the autoscaler windows ``tpu_duty_cycle_percent``.

Metrics published per local device (``chip`` labels are CUDA device
indices; on the CPU the process is one device, chip 0):
  tpu_hbm_used_bytes{chip=...}     ``torch.cuda.memory_stats(i)
                                   ["allocated_bytes.all.current"]``
  tpu_hbm_limit_bytes{chip=...}    ``torch.cuda.mem_get_info(i)[1]``
  tpu_hbm_source{source=...}       where the HBM numbers came from
  tpu_duty_cycle_percent{chip=...} fraction of wall-time the workload had
                                   device execution in flight (see below)
  tpu_tensorcore_utilization_percent{chip=...}
                                   achieved model FLOP rate vs the
                                   catalogue's per-card bf16 peak (MFU as
                                   a percentage; FLOPs reported by the
                                   workload via add_flops inside a
                                   tensorcore_window — burnin reports
                                   ``flops_per_step`` x synced steps,
                                   smoke its matmul's 2mnk)
  tpu_process_devices              local device count of the writer
  tpu_runtime_metrics_timestamp_seconds  staleness marker for scrapers

HBM degradation ladder (tpu_hbm_source names the rung):
  "memory_stats"  the runtime reported the gauges — published as-is. On
                  the CPU no HBM values exist, and the rung is still
                  "memory_stats" with no gauge lines, as the reference
                  publishes for a JAX CPU device.
  "catalogue"     a card whose runtime reported no capacity: the limit
                  comes from the accelerator catalogue
                  (:mod:`tpu_cluster_torch.topology`, resolved from the
                  TPU_ACCELERATOR_TYPE env, else the CUDA device name).
  "none"          the double-miss: unknown card, no override.
The reference's "live_arrays" rung (summing the process's live
``jax.Array`` buffers when the runtime has no memory_stats) has no
counterpart: the CUDA caching allocator always reports its bytes.

Duty cycle (the dcgm-exporter utilization analog): the owning workload
samples itself — ``duty_cycle_window()`` opens a measurement window and
``device_busy()`` marks the regions where device execution is in flight
(dispatch..sync). The gauge is busy/wall over the TRAILING
``TPU_METRICS_WINDOW_S`` (default 60s) seconds: ~0 when scraped after
idle, the live rate mid-run. Attributed to every local device the
process owns. No window, or a window that never saw activity, publishes
nothing — the gauge is only ever a measured value. Same window semantics
for tensorcore utilization.

The write is atomic (tmp + rename) so the exporter never relays a torn
file, and never raises: metrics plumbing must not fail the workload.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Deque, Dict, Iterator, List, Optional, Tuple

DEFAULT_PATH = "/run/tpu/metrics.prom"   # legacy single-writer path
DEFAULT_DIR = "/run/tpu/metrics.d"       # multi-writer drop-dir

# The exporter-relayed family names other processes lean on (the
# autoscaler windows the duty cycle; the contract registry pins both).
DUTY_CYCLE_PERCENT = "tpu_duty_cycle_percent"
TENSORCORE_UTILIZATION_PERCENT = "tpu_tensorcore_utilization_percent"


def writer_id() -> str:
    """Stable per-writer filename stem: hostname (the pod name inside a
    container) + pid. Pid alone is NOT unique across pods sharing the
    hostPath — each container has its own pid namespace."""
    import socket

    host = socket.gethostname() or "host"
    return f"{host}-{os.getpid()}"


def resolved_path() -> str:
    """The textfile path a workload should publish to:

    1. ``TPU_METRICS_FILE`` env (tests / custom mounts) wins;
    2. else a per-writer file in the ``metrics.d`` drop-dir under the
       exporter hostPath, so concurrent workloads on a node publish side
       by side (the exporter relays the union, evicting stale files);
    3. legacy single-file path when the hostPath exists but the drop-dir
       cannot be created (read-only mount), or no hostPath at all (then
       :func:`write` declines).
    """
    env = os.environ.get("TPU_METRICS_FILE")
    if env:
        return env
    if os.path.isdir(os.path.dirname(DEFAULT_DIR)):
        try:
            os.makedirs(DEFAULT_DIR, exist_ok=True)
            return os.path.join(DEFAULT_DIR, f"{writer_id()}.prom")
        except OSError:
            pass
    return DEFAULT_PATH


DEFAULT_WINDOW_S = 60.0


def _window_s() -> float:
    try:
        return float(os.environ.get("TPU_METRICS_WINDOW_S",
                                    DEFAULT_WINDOW_S))
    except ValueError:
        return DEFAULT_WINDOW_S


class _WindowAccumulator:
    """Trailing-window machinery shared by both samplers: events are
    ``(end_time, weight, duration)`` — a point event has duration 0, a
    region event spreads its weight uniformly over ``[end-dur, end]`` and
    contributes only the in-window part."""

    def __init__(self, window_s: Optional[float]) -> None:
        self.window = float(window_s) if window_s else _window_s()
        self._t0 = time.monotonic()
        self._events: Deque[Tuple[float, float, float]] = \
            collections.deque()
        self.ever = False

    def add(self, weight: float, duration: float = 0.0,
            now: Optional[float] = None) -> None:
        if weight > 0:
            end = time.monotonic() if now is None else now
            self._events.append((end, weight, max(0.0, duration)))
            self.ever = True

    def windowed(self, now: Optional[float] = None) -> Tuple[float, float]:
        """(in-window weight, span seconds). Evicts events entirely before
        the window."""
        now = time.monotonic() if now is None else now
        start = max(self._t0, now - self.window)
        while self._events and self._events[0][0] <= start:
            self._events.popleft()
        total = 0.0
        for end, weight, dur in self._events:
            if end > now:
                continue  # injected future 'now' in tests
            if dur <= 0.0:
                total += weight if end > start else 0.0
            else:
                overlap = max(0.0, min(end, now) - max(end - dur, start))
                total += weight * (overlap / dur)
        return total, now - start


class DutyCycleSampler:
    """Device-busy seconds over a TRAILING window (busy/wall of the last
    ``window_s`` seconds, clipped to the window's open time). ``None``
    until the first busy region is recorded; ``0.0`` once activity has
    been seen but none falls in the trailing window. ``total_busy_s``
    sums every region recorded."""

    def __init__(self, window_s: Optional[float] = None) -> None:
        self._acc = _WindowAccumulator(window_s)
        self._t0 = self._acc._t0
        self.total_busy_s = 0.0

    def add_busy(self, seconds: float, now: Optional[float] = None) -> None:
        self._acc.add(seconds, duration=seconds, now=now)
        if seconds > 0:
            self.total_busy_s += seconds

    def percent(self, now: Optional[float] = None) -> Optional[float]:
        busy, span = self._acc.windowed(now)
        if not self._acc.ever or span <= 1e-9:
            return None
        return min(100.0, 100.0 * busy / span)


class TensorcoreSampler:
    """Executed model FLOPs over a TRAILING window — the dcgm-exporter
    tensorcore-utilization analog. The owning workload reports the FLOPs
    it measurably executed and the gauge is achieved/peak against the
    catalogue's per-card bf16 peak, over the last ``window_s`` seconds
    (same ``None``-until-measured / ``0.0``-when-idle semantics as
    :class:`DutyCycleSampler`)."""

    def __init__(self, window_s: Optional[float] = None) -> None:
        self._acc = _WindowAccumulator(window_s)
        self._t0 = self._acc._t0
        self._total_flops = 0.0

    def add_flops(self, flops: float, now: Optional[float] = None) -> None:
        self._acc.add(flops, now=now)
        if flops > 0:
            self._total_flops += flops

    def percent(self, n_devices: int, peak_tflops_per_chip: float,
                now: Optional[float] = None) -> Optional[float]:
        flops, span = self._acc.windowed(now)
        if (self._total_flops <= 0 or span <= 1e-9 or n_devices <= 0
                or peak_tflops_per_chip <= 0):
            return None
        achieved_per_chip = flops / span / 1e12 / n_devices
        return min(100.0, 100.0 * achieved_per_chip / peak_tflops_per_chip)


_active_sampler: Optional[DutyCycleSampler] = None
_active_tensorcore: Optional[TensorcoreSampler] = None


@contextlib.contextmanager
def duty_cycle_window() -> Iterator[DutyCycleSampler]:
    """Open a duty-cycle measurement window; :func:`device_busy` regions
    inside it feed the yielded sampler and ``collect_lines`` publishes the
    gauge while it is open."""
    global _active_sampler
    sampler = DutyCycleSampler()
    prev, _active_sampler = _active_sampler, sampler
    try:
        yield sampler
    finally:
        _active_sampler = prev


@contextlib.contextmanager
def tensorcore_window() -> Iterator[TensorcoreSampler]:
    """Open a tensorcore-utilization window; workloads report executed
    FLOPs via :func:`add_flops` and ``collect_lines`` publishes the gauge
    while it is open."""
    global _active_tensorcore
    sampler = TensorcoreSampler()
    prev, _active_tensorcore = _active_tensorcore, sampler
    try:
        yield sampler
    finally:
        _active_tensorcore = prev


def add_flops(flops: float) -> None:
    """Report model FLOPs whose device execution has completed (call after
    the sync). No-op without an open tensorcore window."""
    if _active_tensorcore is not None:
        _active_tensorcore.add_flops(flops)


def add_busy(seconds: float) -> None:
    """Report device-busy seconds measured elsewhere, ending now (the
    collective ranks ``collectives.run_ranks`` starts in processes of
    their own measure theirs). No-op without an open duty-cycle window."""
    if _active_sampler is not None:
        _active_sampler.add_busy(seconds)


@contextlib.contextmanager
def device_busy() -> Iterator[None]:
    """Mark a region with device execution in flight (dispatch..sync).
    No-op when no duty-cycle window is open, so workloads can annotate
    unconditionally."""
    sampler = _active_sampler
    t0 = time.monotonic()
    try:
        yield
    finally:
        if sampler is not None:
            sampler.add_busy(time.monotonic() - t0)


def local_devices() -> list:
    """The device this process owns: its current card (one rank a card:
    ``collectives.run_ranks`` and ``multihost.initialize`` set each
    rank's), else the CPU as one device. Not every visible card: where the
    reference's one JAX process owns every local chip, a port process
    computes on one, and the other cards' processes publish their own."""
    import torch

    if torch.cuda.is_available():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cpu")]


def chip_id(device) -> int:
    """The ``chip`` label of a device: its CUDA index, 0 for the CPU."""
    return device.index if device.type == "cuda" else 0


def _resolve_accelerator(devices):
    """Catalogue entry for the local cards: the TPU_ACCELERATOR_TYPE env
    wins, else the CUDA device name; None on the CPU or an unknown card."""
    from .. import topology

    acc_env = topology.canonical_name(os.environ.get(
        "TPU_ACCELERATOR_TYPE", ""))
    if acc_env in topology.ACCELERATOR_TYPES:
        return topology.get(acc_env)
    if devices and devices[0].type == "cuda":
        import torch

        return topology.from_device_name(
            torch.cuda.get_device_name(devices[0]))
    return None


def collect_lines(now: Optional[float] = None) -> List[str]:
    from .smoke import hbm_stats

    lines = [
        "# HELP tpu_hbm_used_bytes HBM bytes in use (per chip, from the "
        "owning JAX process)",
        "# TYPE tpu_hbm_used_bytes gauge",
    ]
    devices = local_devices()
    in_use: Dict[int, int] = {}
    limits: Dict[int, int] = {}
    for d in devices:
        stats = hbm_stats(d)
        if "bytes_in_use" in stats:
            in_use[chip_id(d)] = stats["bytes_in_use"]
        if "bytes_limit" in stats:
            limits[chip_id(d)] = stats["bytes_limit"]
    source = "memory_stats"
    if not limits and devices and devices[0].type == "cuda":
        # the runtime reported no capacity: the catalogue's, or "none"
        # when the card is unknown (never a fabricated value)
        acc = _resolve_accelerator(devices)
        if acc is not None:
            source = "catalogue"
            limits = {chip_id(d): acc.hbm_gib_per_chip << 30
                      for d in devices}
        else:
            source = "none"
            in_use = {}
    for chip, val in sorted(in_use.items()):
        lines.append(f'tpu_hbm_used_bytes{{chip="{chip}"}} {val}')
    lines += ["# HELP tpu_hbm_limit_bytes HBM capacity visible to the runtime",
              "# TYPE tpu_hbm_limit_bytes gauge"]
    for chip, val in sorted(limits.items()):
        lines.append(f'tpu_hbm_limit_bytes{{chip="{chip}"}} {val}')
    lines += [
        "# HELP tpu_hbm_source where the HBM gauges came from",
        "# TYPE tpu_hbm_source gauge",
        f'tpu_hbm_source{{source="{source}"}} 1',
    ]
    duty = _active_sampler.percent() if _active_sampler else None
    if duty is not None:
        # HELP text carries no writer-specific values (two writers must
        # dedup to one HELP line in the exporter's union)
        lines += [
            f"# HELP {DUTY_CYCLE_PERCENT} fraction of wall-time the owning "
            "workload had device execution in flight, over the trailing "
            "window published as tpu_metrics_window_seconds "
            "(process-scoped: one value, every local chip)",
            f"# TYPE {DUTY_CYCLE_PERCENT} gauge",
        ]
        for d in devices:
            lines.append(
                f'{DUTY_CYCLE_PERCENT}{{chip="{chip_id(d)}"}} {duty:.1f}')
    tc = None
    if _active_tensorcore is not None:
        acc = _resolve_accelerator(devices)
        if acc is not None and acc.peak_bf16_tflops > 0:
            tc = _active_tensorcore.percent(len(devices),
                                            acc.peak_bf16_tflops)
    if tc is not None:
        lines += [
            f"# HELP {TENSORCORE_UTILIZATION_PERCENT} achieved model "
            "FLOP rate vs the per-chip bf16 peak (MFU, as a percentage) "
            "over the trailing window published as "
            "tpu_metrics_window_seconds",
            f"# TYPE {TENSORCORE_UTILIZATION_PERCENT} gauge",
        ]
        for d in devices:
            # %.4g keeps a measured-but-tiny rate nonzero instead of
            # rounding it to an absent-looking 0.0
            lines.append(
                f'{TENSORCORE_UTILIZATION_PERCENT}{{chip="{chip_id(d)}"}} '
                f'{tc:.4g}')
    lines += [
        "# HELP tpu_process_devices local devices owned by the writer",
        "# TYPE tpu_process_devices gauge",
        f"tpu_process_devices {len(devices)}",
        "# HELP tpu_metrics_window_seconds trailing window the duty/"
        "tensorcore gauges are computed over",
        "# TYPE tpu_metrics_window_seconds gauge",
        f"tpu_metrics_window_seconds {_window_s():g}",
        "# TYPE tpu_runtime_metrics_timestamp_seconds gauge",
        f"tpu_runtime_metrics_timestamp_seconds "
        f"{int(now if now is not None else time.time())}",
    ]
    return lines


def write(path: str = DEFAULT_PATH,
          now: Optional[float] = None) -> Optional[str]:
    """Atomically publish current metrics; returns the path written, or None
    when the directory doesn't exist (node without the exporter hostPath)
    or anything failed — metrics plumbing never fails the workload."""
    directory = os.path.dirname(path) or "."
    if not os.path.isdir(directory):
        return None
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(collect_lines(now)) + "\n")
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001 — device enumeration errors included
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path
