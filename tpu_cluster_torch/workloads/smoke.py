"""Single-card smoke workloads — nvidia-smi / cuda-vector-add analogs, the
port's counterpart of ``tpu_cluster/workloads/smoke.py``.

A validation Job that was granted a card runs these; their output is the
golden output the runbook compares against. The JSON keys are the
reference's. Every function takes a ``device``: ``None`` means the card,
and the CPU runs only when a caller asks for it.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from . import runtime_metrics
from .burnin import DeviceLike, resolve_device


def _rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def device_report(device: DeviceLike = None) -> Dict[str, Any]:
    """Device enumeration — the nvidia-smi table analog: platform
    (``"gpu"`` for a card, ``"cpu"``), device counts, the process's rank,
    and per device its index, name and HBM stats. ``device_count`` is this
    process's devices; ``validate`` counts the global total across ranks."""
    dev = resolve_device(device)
    rank = _rank()
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    report: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "device_count": len(devices),
        "local_device_count": len(devices),
        "process_index": rank,
        "devices": [],
    }
    for d in devices:
        kind = torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"
        entry: Dict[str, Any] = {"id": runtime_metrics.chip_id(d),
                                 "kind": kind, "process": rank}
        stats = hbm_stats(d)
        if "bytes_limit" in stats:
            entry["hbm_bytes_limit"] = stats["bytes_limit"]
        if "bytes_in_use" in stats:
            entry["hbm_bytes_in_use"] = stats["bytes_in_use"]
        report["devices"].append(entry)
    return report


def hbm_stats(device: torch.device) -> Dict[str, int]:
    """Normalized per-device HBM stats: ``bytes_in_use`` (the caching
    allocator's live bytes) and ``bytes_limit`` (the card's capacity as
    ``mem_get_info`` reports it); {} on the CPU, or where the runtime
    cannot say."""
    if device.type != "cuda":
        return {}
    out: Dict[str, int] = {}
    try:
        stats = torch.cuda.memory_stats(device)
        if "allocated_bytes.all.current" in stats:
            out["bytes_in_use"] = int(stats["allocated_bytes.all.current"])
        out["bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    except RuntimeError:
        pass
    return out


def vector_add(n: int = 1 << 20, device: DeviceLike = None
               ) -> Dict[str, Any]:
    """cuda-vector-add analog: an elementwise add on the device, checked
    element-wise against numpy on the host."""
    dev = resolve_device(device)
    a = torch.arange(n, dtype=torch.float32, device=dev)
    b = torch.full((n,), 2.0, dtype=torch.float32, device=dev)
    out = (a + b).cpu().numpy()
    expect = np.arange(n, dtype=np.float32) + 2.0
    ok = bool(np.array_equal(out, expect))
    return {"check": "vector_add", "n": n, "ok": ok}


def matmul_chain(m: int, k: int, n: int, dtype: torch.dtype, iters: int,
                 device: DeviceLike = None
                 ) -> Tuple[Callable[[], Tuple[float, torch.Tensor]], float]:
    """Chained-carry matmul for timing reuse: ``iters`` products, each fed
    the previous one's output (so none can be skipped), scaled by
    ``1/sqrt(k)`` to keep the carry bounded. Requires k == n.

    Returns ``(run, flops)``: ``run()`` executes one timed pass (marking
    the duty-cycle producer region, reporting FLOPs after the sync) and
    returns ``(seconds, out)``; the sync is a one-element host fetch.
    ``flops`` is the pass's total FLOP count. One warm-up pass runs here
    (library handles, allocator), so callers time steady state."""
    if k != n:
        raise ValueError(f"chained-carry benchmark needs k == n, got "
                         f"k={k} n={n}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
    scale = torch.tensor(1.0 / np.sqrt(k), dtype=dtype, device=dev)

    def chain() -> torch.Tensor:
        x = a
        for _ in range(iters):
            x = (x @ b) * scale
        return x

    chain()[:1, :1].cpu()  # warm-up
    flops = 2.0 * m * k * n * iters

    def run() -> Tuple[float, torch.Tensor]:
        t0 = time.perf_counter()
        with runtime_metrics.device_busy():  # duty-cycle producer region
            out = chain()
            out[:1, :1].cpu()  # the sync: a one-element fetch
        dt = time.perf_counter() - t0
        runtime_metrics.add_flops(flops)  # tensorcore-utilization producer
        return dt, out

    return run, flops


def matmul(m: int = 4096, k: int = 4096, n: int = 4096,
           dtype: torch.dtype = torch.bfloat16, iters: int = 10,
           device: DeviceLike = None) -> Dict[str, Any]:
    """bf16 matmul smoke + throughput (``torch.matmul``, cuBLAS on the
    card). Timing methodology lives in :func:`matmul_chain`."""
    run, flops = matmul_chain(m, k, n, dtype, iters, device)
    dt, out = run()
    finite = bool(torch.isfinite(out.float()).all())
    return {
        "check": "matmul", "m": m, "k": k, "n": n,
        "dtype": str(dtype).replace("torch.", ""),
        "iters": iters, "seconds": dt,
        "tflops": flops / dt / 1e12, "ok": finite,
    }


def run_suite(matmul_dim: int = 2048, device: DeviceLike = None
              ) -> Dict[str, Any]:
    """The full single-process validation suite, timed (``wall_s``)."""
    t0 = time.perf_counter()
    rep = device_report(device)
    add = vector_add(device=device)
    mm = matmul(matmul_dim, matmul_dim, matmul_dim, device=device)
    wall = time.perf_counter() - t0
    return {
        "device_report": rep,
        "vector_add": add,
        "matmul": mm,
        "ok": add["ok"] and mm["ok"] and rep["device_count"] >= 1,
        "wall_s": wall,
    }


if __name__ == "__main__":
    print(json.dumps(run_suite(), indent=2))
