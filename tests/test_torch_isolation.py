"""The port stands alone: no module of ``tpu_cluster_torch`` (nor
``chip_smoke.py``) imports jax or the reference package, it imports with
jax unavailable, and its engine never quietly runs on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from tpu_cluster_torch.workloads import serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "tpu_cluster"}


def _port_files():
    root = os.path.join(REPO, "tpu_cluster_torch")
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _absolute_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_port_file_imports_jax_or_reference_package():
    files = list(_port_files())
    assert len(files) >= 10
    bad = {os.path.relpath(p, REPO): sorted(set(_absolute_imports(p))
                                            & FORBIDDEN)
           for p in files}
    assert {p: names for p, names in bad.items() if names} == {}


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'tpu_cluster'):\n"
        "    sys.modules[name] = None  # any import of them now fails\n"
        "import tpu_cluster_torch.workloads.serving\n"
        "import tpu_cluster_torch.kernels.flash_attention\n"
        "import chip_smoke\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'tpu_cluster') and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_topology_and_timing_are_copies_not_reexports():
    """The port's catalogue and estimator work with the reference package
    unimportable, and every public name they hold is defined in the
    port (a re-export would name ``tpu_cluster``)."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'tpu_cluster'):\n"
        "    sys.modules[name] = None\n"
        "from tpu_cluster_torch import topology\n"
        "from tpu_cluster_torch.workloads import timing\n"
        "for mod in (topology, timing):\n"
        "    for name in dir(mod):\n"
        "        owner = getattr(getattr(mod, name), '__module__', None)\n"
        "        assert owner is None or not owner.startswith('tpu_cluster.'),"
        " (mod.__name__, name, owner)\n"
        "assert timing.paired_two_point([(1.0, 3.0)], 2e12, 3e12)['tflops'] "
        "== 1.0\n"
        "assert topology.from_device_name('NVIDIA H100 80GB HBM3') is "
        "topology.get('h100-sxm5-80gb')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    eng = serving.InferenceEngine(serving.ServingConfig())
    assert eng.device == torch.device("cuda")
    eng.submit((1, 2, 3), max_new_tokens=1)
    with pytest.raises(RuntimeError):
        eng.step()
    assert eng.iterations == 0
