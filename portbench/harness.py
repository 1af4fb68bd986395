"""What every run shares: finding a cell, its configuration, its traffic,
its driver and its metrics' readers by name; the card check; the result
line; and the check that no JAX module was loaded.

A cell is ``workloads/<cell>.json``. It names its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``)
and its driver (``drivers/<driver>.py``). A metric of ``BENCHMARK.json``
is read by ``metrics/<metric>.py``. A new cell, configuration, traffic
mix or metric is a new file and a new entry; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

# Top-level module names that may not be loaded in a run: the JAX stack
# and the JAX package the port was made from. Compared as whole names:
# the port's own name begins with the JAX package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_cluster")

# A tail that lands on a miss is +inf; the line carries this instead,
# which fails any bound.
INF_VALUE_MS = 1e9


class NoCard(RuntimeError):
    """No card, or fewer than the cell asks for."""


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import a file of the benchmark by its path (metric names carry a
    '.', which a module name cannot)."""
    name = (f"portbench._{path.parent.name}_"
            + path.stem.replace(".", "_").replace("-", "_"))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell as its files describe it, with this run's arguments."""

    name: str
    spec: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    limits: Dict[str, float] = field(default_factory=dict)

    @property
    def model(self) -> Dict[str, int]:
        return self.config["model"]

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])


def load_cell(name: str, seed: int = 0, seconds: float = 10.0,
              trace: bool = False) -> Cell:
    spec = load_json(HERE / "workloads" / f"{name}.json")
    return Cell(name=name, spec=spec,
                config=load_json(HERE / "configs" / f"{spec['config']}.json"),
                traffic=load_json(HERE / "traffic" / f"{spec['traffic']}.json"),
                seed=seed, seconds=seconds, trace=trace,
                limits=dict(spec.get("limits", {})))


def driver(cell: Cell) -> ModuleType:
    return load_module(HERE / "drivers" / f"{cell.spec['driver']}.py")


def benchmark_metrics(cell_name: str, section: str) -> List[Dict[str, Any]]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") of
    ``BENCHMARK.json`` that ``cell_name`` reports: those that list it,
    and those that list no cells."""
    doc = load_json(BENCHMARK)
    return [m for m in doc[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    return load_module(HERE / "metrics" / f"{metric}.py").read


def read_metrics(cell_name: str, section: str, rec: Dict[str, Any]
                 ) -> Dict[str, Dict[str, Any]]:
    """Each listed metric's reader over the run's record; a reader that
    finds nothing leaves its metric out."""
    out: Dict[str, Dict[str, Any]] = {}
    for m in benchmark_metrics(cell_name, section):
        value = reader(m["name"])(rec)
        if value is None:
            continue
        if math.isinf(value):
            value = INF_VALUE_MS
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark runs on the card only")
    have = torch.cuda.device_count()
    if have < chips:
        raise NoCard(f"the cell needs {chips} card(s), {have} visible")


def pin_caches() -> None:
    """Every build and kernel cache in fixed directories of the checkout.
    The port's own kernels build into ``build/kernels/`` there already."""
    base = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def device_info(memory_peak: int, dev_trace=None) -> Dict[str, Any]:
    import torch

    out: Dict[str, Any] = {"platform": "gpu",
                           "kind": torch.cuda.get_device_name(0),
                           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if dev_trace is not None:
        out["busy_s"] = dev_trace.busy_s
        out["window_s"] = dev_trace.window_s
    return out


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Any], device: Dict[str, Any],
                checks: Dict[str, Dict[str, float]],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    doc: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        doc["breakdown"] = breakdown
    doc["checks"] = checks  # last: each number compared, beside its limit
    return json.dumps(doc)


def check_lines(checks: Dict[str, Dict[str, float]]) -> str:
    return "\n".join(f"check {name}: {c['value']!r} limit {c['limit']!r}"
                     for name, c in checks.items())


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit. A number with no limit in the cell
    file is a fault of the cell file."""
    return {name: {"value": float(v), "limit": float(limits[name])}
            for name, v in numbers.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
