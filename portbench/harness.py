"""What every run shares: finding a cell, its configuration, its traffic,
its driver and its metrics' readers by name; the card check; the result
line; the check that no JAX module was loaded; and the benchmark's
contract (:func:`contract_problems`).

A cell is ``workloads/<cell>.json``. It names its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``)
and its driver (``drivers/<driver>.py``). A metric of ``BENCHMARK.json``
is read by ``metrics/<metric>.py``. A new cell, configuration, traffic
mix or metric is a new file and a new entry; nothing here changes.

A driver declares what it needs of the rest: ``run`` (one run of a
cell), ``calibration`` (the readings its limits are set from),
``COMPARED`` (the numbers its runs judge, each a limit of the cell's
file) and ``check_model`` (raises on a configuration it cannot run). So
a new architecture brings its own driver, its inputs, its plain
reference under ``reference/`` and its work counts, all as new files.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Mapping, Optional

from portbench import trace

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


def driver_module(name: str) -> ModuleType:
    path = HERE / "drivers" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no driver {name!r} ({path})")
    return load_module(path)


def driver(cell: Cell) -> ModuleType:
    return driver_module(cell.spec["driver"])


def benchmark_metrics(cell_name: str, section: str) -> List[Dict[str, Any]]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") of
    ``BENCHMARK.json`` that ``cell_name`` reports: those that list it,
    and those that list no cells."""
    doc = load_json(BENCHMARK)
    return [m for m in doc[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for {metric!r} ({path})")
    return load_module(path).read


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


def judged(cell: Cell, numbers: Dict[str, float]) -> Dict[str, Any]:
    """One calibration reading as a run judges it, by the cell's limits."""
    return {"numbers": numbers, "correct": passed(judge(numbers, cell.limits))}


# ------------------------------------------------------------ the contract

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
END_TO_END_SOURCES = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# a width never cut: a key of `reduced` may not end so
WIDTH_SUFFIXES = ("_dim", "_rank")
MAX_DOC_BYTES = 64 * 1024
MAX_TEXT = 200


def _text(value: Any) -> bool:
    return (isinstance(value, str) and 1 <= len(value) <= MAX_TEXT
            and "\n" not in value and "\t" not in value)


def contract_problems(doc: Dict[str, Any],
                      read: Optional[Callable[[str], Dict[str, Any]]] = None,
                      drivers: Optional[Mapping[str, Any]] = None
                      ) -> List[str]:
    """What in ``doc`` (the content of ``BENCHMARK.json``) and in the files
    it names breaks the benchmark's contract; empty where nothing does.

    ``read`` gives a JSON file of the checkout by its path from the root
    (default: the file on disk); ``drivers`` gives driver modules by name
    ahead of ``drivers/<name>.py``. Each cell's limits are exactly its
    driver's ``COMPARED``, and each configuration passes the
    ``check_model`` of every driver that runs it.
    """
    read = read or (lambda rel: load_json(ROOT / rel))
    out: List[str] = []

    def need(ok: Any, what: str) -> None:
        if not ok:
            out.append(what)

    need(set(doc) == TOP_KEYS, f"top-level keys {sorted(doc)}")
    need(doc.get("paths") == [HERE.name], f"paths {doc.get('paths')}")
    need(all(not w.startswith("/") and ".." not in w
             for w in doc.get("command", [])), "command leaves the checkout")
    need(isinstance(doc.get("run_seconds"), int)
         and 1 <= doc["run_seconds"] <= 51,
         f"run_seconds {doc.get('run_seconds')}")
    need(len(json.dumps(doc)) < MAX_DOC_BYTES, "BENCHMARK.json over 64 KiB")
    for group in ("configs", "workloads", "metrics"):
        entries = (doc["end_to_end"] + doc["per_layer"] if group == "metrics"
                   else doc[group])
        names = [x["name"] for x in entries]
        need(len(names) == len(set(names)), f"{group}: a name twice")
        for n in names:
            need(NAME.match(n), f"{group}: bad name {n!r}")
    cells = _cell_problems(doc, read, drivers or {}, need)
    _config_problems(doc, read, cells, need)
    _metric_problems(doc, need)
    _kernel_name_problems(need)
    return out


def _cell_problems(doc, read, drivers, need) -> Dict[str, Dict[str, Any]]:
    """Each cell's files, driver and limits; the cells that load, with
    their spec, traffic and driver."""
    cells: Dict[str, Dict[str, Any]] = {}
    for w in doc["workloads"]:
        cell = w["name"]
        need(NAME.match(w["config"]) and NAME.match(w["traffic"]),
             f"{cell}: bad config or traffic name")
        need(_text(w["why"]), f"{cell}: why is not one line of 1-200")
        try:
            spec = read(f"{HERE.name}/workloads/{cell}.json")
            mix = read(f"{HERE.name}/traffic/{spec['traffic']}.json")
            name = spec["driver"]
            drv = drivers[name] if name in drivers else driver_module(name)
        except (OSError, KeyError, ValueError) as exc:
            need(False, f"{cell}: not found by name: {exc}")
            continue
        cells[cell] = {"spec": spec, "traffic": mix, "driver": drv}
        need(spec["config"] == w["config"], f"{cell}: config differs")
        need(spec["traffic"] == w["traffic"], f"{cell}: traffic differs")
        need(spec.get("chips") == w["chips"] == 1, f"{cell}: chips")
        need(callable(getattr(drv, "run", None))
             and callable(getattr(drv, "calibration", None)),
             f"{cell}: driver {name!r} lacks run or calibration")
        compared = getattr(drv, "COMPARED", None)
        need(compared is not None
             and set(spec.get("limits", {})) == set(compared),
             f"{cell}: limits {sorted(spec.get('limits', {}))} are not what "
             f"driver {name!r} compares ({sorted(compared or ())})")
        if mix.get("kind") != "train":
            need(_text(mix.get("source")), f"{cell}: mix names no source")
            need(mix.get("assumed"), f"{cell}: mix lists nothing assumed")
            need({"prompt.max", "output.max"} <= set(mix.get("reduced", {})),
                 f"{cell}: mix lists no prompt.max and output.max cuts")
    return cells


def _config_problems(doc, read, cells, need) -> None:
    """Each configuration's file, its cuts, and its model against every
    driver that runs it and every cell's lengths."""
    for config in doc["configs"]:
        name = config["name"]
        need(config["file"].startswith(f"{HERE.name}/configs/"),
             f"{name}: file outside {HERE.name}/configs/")
        try:
            cfg = read(config["file"])
        except (OSError, ValueError) as exc:
            need(False, f"{name}: {exc}")
            continue
        need(cfg.get("name") == name, f"{name}: file names {cfg.get('name')}")
        need(sorted(cfg.get("reduced", {})) == sorted(config["reduced"]),
             f"{name}: reduced differs from its file")
        for key in config["reduced"]:
            need(NAME.match(key), f"{name}: bad reduced key {key!r}")
            need(not key.endswith(WIDTH_SUFFIXES),
                 f"{name}: reduced names a width, {key!r}")
        mine = [c for w, c in ((w, cells.get(w["name"]))
                               for w in doc["workloads"])
                if c is not None and w["config"] == name]
        need(mine, f"{name}: no cell runs it")
        model = cfg.get("model", {})
        for drv in {id(c["driver"]): c["driver"] for c in mine}.values():
            try:
                drv.check_model(model)
            except (ValueError, KeyError) as exc:
                need(False, f"{name}: driver {drv.__name__} refuses it: "
                            f"{exc}")
        longest = max((max(c["traffic"].get("seq", 0),
                           c["spec"].get("engine", {}).get("seq", 0))
                       for c in mine), default=0)
        need(model.get("context", 0) >= longest,
             f"{name}: context {model.get('context')} under a cell's "
             f"{longest}")


def _metric_problems(doc, need) -> None:
    """Readers, units, bounds, sources and layers; what each cell
    reports."""
    cells = [w["name"] for w in doc["workloads"]]
    e2e, per_layer = doc["end_to_end"], doc["per_layer"]
    for m in e2e + per_layer:
        need(NAME.match(m["name"]) and UNIT.match(m["unit"]),
             f"{m['name']}: bad name or unit")
        need(m["better"] in ("lower", "higher"), f"{m['name']}: better")
        try:
            need(callable(reader(m["name"])), f"{m['name']}: no read()")
        except (OSError, ImportError) as exc:
            need(False, f"{m['name']}: {exc}")
        need(set(m.get("workloads", cells)) <= set(cells),
             f"{m['name']}: lists a cell that is not one")
    for m in e2e:
        need(0.01 <= m.get("bound", -1) <= 0.25, f"{m['name']}: bound")
        need(m["source"] in END_TO_END_SOURCES, f"{m['name']}: source")
    layers: Dict[str, set] = {}
    for m in per_layer:
        need(m["source"] in SOURCES, f"{m['name']}: source")
        need("bound" not in m, f"{m['name']}: a per-layer bound")
        need(m["moves"] in {x["name"] for x in e2e},
             f"{m['name']}: moves {m['moves']}")
        need(_text(m["layer"]), f"{m['name']}: layer is not one line")
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for prefix, texts in layers.items():
        need(len(texts) == 1, f"{prefix}: layer texts {sorted(texts)}")
    # each cell reports set-up, another end-to-end metric and a layer's
    for cell in cells:
        mine = {m["name"] for m in e2e if cell in m.get("workloads", cells)}
        layer = [m for m in per_layer if cell in m.get("workloads", cells)]
        need("setup_s" in mine and len(mine) >= 2 and layer,
             f"{cell}: reports too little")
        for m in layer:
            need(m["moves"] in mine,
                 f"{cell}: {m['name']} moves {m['moves']}, not reported")


def _kernel_name_problems(need) -> None:
    """Each name under ``kernel_names/`` is a kernel of the port's CUDA
    sources."""
    sources = "".join(p.read_text() for p in
                      (ROOT / "tpu_cluster_torch" / "csrc").glob("*.cu"))
    for group in sorted(p.name for p in (HERE / "kernel_names").iterdir()
                        if p.is_dir()):
        names = trace.kernel_names(group)
        need(names, f"kernel_names/{group}: empty")
        for n in names:
            need(re.search(r"__global__.{0,200}?\b" + re.escape(n) + r"\(",
                           sources, re.S),
                 f"kernel_names/{group}: {n} is no kernel of the port")
