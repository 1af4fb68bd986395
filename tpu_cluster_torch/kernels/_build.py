"""Build the port's CUDA sources into shared libraries and load them.

Each ``tpu_cluster_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the repository
root, where ``<hash>`` covers the sources under ``csrc/`` and the flags,
so an edited source builds anew and an unchanged one is reused. The
library exports a plain C interface and is loaded with ``ctypes``; no
PyTorch header is compiled, which keeps a build to seconds.

Nothing here runs at import: the build happens on first use (or when a
caller asks for it with :func:`build`), and only on a machine with the
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# The flash-attention sources (K1, K2, K3), each built on
# csrc/hopper_common.cuh's TMA and wgmma primitives.
FLASH_SOURCES: Sequence[str] = ("flash_attn_fwd", "flash_attn_bwd_dkv",
                                "flash_attn_bwd_dq")
# Every kernel source of the port, by stem under csrc/: the flash kernels
# and the decode attention (cp.async and the CUDA cores).
SOURCES: Sequence[str] = (*FLASH_SOURCES, "decode_attn")

NVCC_FLAGS: Sequence[str] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, in the build log
    "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels build only where the CUDA "
                       "toolkit is installed")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current
    sources and flags."""
    digest = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler log (ptxas registers, shared memory and spills per
    kernel) kept beside the library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log")


def build(names: Sequence[str] = SOURCES) -> None:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together, keeping each compiler log
    at :func:`log_path`; raise RuntimeError naming the source when a
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        log_path(name).write_text(log)
        os.replace(tmp, out)  # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
