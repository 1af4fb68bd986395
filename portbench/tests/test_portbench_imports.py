"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the plain reference loads nothing of the
port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench import harness

LOAD_ALL = """
import json, sys
from portbench import harness, run, calibrate, sweep
for w in harness.load_json(harness.BENCHMARK)["workloads"]:
    harness.driver(harness.load_cell(w["name"]))
doc = harness.load_json(harness.BENCHMARK)
for m in doc["end_to_end"] + doc["per_layer"]:
    harness.reader(m["name"])
from portbench.drivers import train
from portbench import serve
train.program(); serve.program()
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_jax_module_in_what_a_run_loads():
    loaded = _loaded(LOAD_ALL)
    assert "tpu_cluster_torch" in loaded and "torch" in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES)


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("tpu_cluster_torch", sys.modules[__name__])
    assert "tpu_cluster" not in harness.forbidden_loaded()


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "tpu_cluster_torch", "tpu_cluster", "jax"), (path, name)
    loaded = _loaded("import json, sys\n"
                     "import portbench.reference.model, "
                     "portbench.reference.engine_weights\n"
                     "print(json.dumps(sorted({m.split('.', 1)[0] "
                     "for m in sys.modules})))")
    assert not loaded & {"tpu_cluster_torch", "tpu_cluster", "jax"}
