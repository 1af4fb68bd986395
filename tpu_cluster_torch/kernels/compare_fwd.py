"""Time K1 (``csrc/flash_attn_fwd.cu``) against other versions of its
source, in turns, on one card.

    python -m tpu_cluster_torch.kernels.compare_fwd DIR [DIR ...]

Each DIR holds another ``flash_attn_fwd.cu`` with the headers it includes
(for example the parent commit's: ``python -m
tpu_cluster_torch.kernels.compare_bwd --export HEAD build/kernels/parent``
writes every ``csrc`` file of a git revision there); it is built with
the same nvcc flags as the port's kernels into ``DIR/libflash_attn_fwd.so``.
At the serving shape (B4 H16 S8192 D256, no lse) and at the training shape
(B1, with lse), every version is first checked against the plain version
(batch row 0), then timed with CUDA events (median of 20 launches after 3
warm-ups) in turns: the other versions, the current source twice, the
other versions in reverse order. One call of
``F.scaled_dot_product_attention`` on the same tensors is timed beside
them as the yardstick. Prints the card's name and power limit, each
version's ptxas summary and one JSON line of times; exits non-zero if a
version disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from . import _build
from . import flash_attention as fa

SHAPES = {"serving": (4, 16, 8192, 256, False),
          "training": (1, 16, 8192, 256, True)}
# As chip_smoke.py: one bf16 ulp at magnitudes in [2, 4); lse in f32.
MAX_ABS = 1.6e-2
LSE_ATOL = 1e-4
PEAK_BF16_FLOPS = 989e12


def build_other(src_dir: Path, name: str = "flash_attn_fwd") -> ctypes.CDLL:
    """Build ``src_dir/<name>.cu`` with the port's nvcc flags into
    ``src_dir/lib<name>.so``, print its ptxas summary, and load it."""
    out = src_dir / f"lib{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
         str(src_dir / f"{name}.cu")],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {src_dir}/{name}.cu failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    summary(str(src_dir), proc.stdout + proc.stderr)
    return ctypes.CDLL(str(out))


def export_sources(rev: str, out_dir: Path) -> None:
    """Write every file of ``tpu_cluster_torch/csrc`` at git revision
    ``rev`` into ``out_dir`` (run where the repository's git history is,
    before the directory is taken to the card)."""
    csrc = "tpu_cluster_torch/csrc"
    names = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{csrc}"],
                           capture_output=True, text=True,
                           check=True).stdout.split()
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in names:
        text = subprocess.run(["git", "show", f"{rev}:{csrc}/{name}"],
                              capture_output=True, check=True).stdout
        (out_dir / name).write_bytes(text)
    print(f"{rev}:{csrc} -> {out_dir}: {' '.join(names)}")


def power_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def summary(label: str, log: str) -> None:
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {label}: {line.strip()}")


def launcher(lib: ctypes.CDLL):
    fn = lib.flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_int64] * 12 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v, o, lse, scale):
        stream = torch.cuda.current_stream().cuda_stream
        strides = [s for x in (q, k, v, o) for s in x.stride()[:3]]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 0 if lse is None else lse.data_ptr(), *q.shape, *strides,
                 scale, stream)
        if err != 0:
            raise RuntimeError(f"flash_attn_fwd launch failed ({err})")
    return run


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("compare_fwd: no CUDA device", file=sys.stderr)
        return 2
    print(power_line())
    _build.build(["flash_attn_fwd"])
    summary("current", _build.log_path("flash_attn_fwd").read_text())
    versions = {"current": launcher(_build.load("flash_attn_fwd"))}
    for arg in argv:
        versions[arg] = launcher(build_other(Path(arg)))
    others = [name for name in versions if name != "current"]
    turns = others + ["current", "current"] + others[::-1]

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    ok = True
    for label, (b, h, s, d, with_lse) in SHAPES.items():
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        o = torch.empty_like(q)
        lse = (torch.empty((b, h, s), device="cuda") if with_lse else None)
        ref_o, ref_lse = fa.flash_attention_reference(q[:1], k[:1], v[:1],
                                                      scale, True)
        for name, run in versions.items():
            run(q, k, v, o, lse, scale)
            torch.cuda.synchronize()
            err = (o[:1].float() - ref_o.float()).abs().max().item()
            lse_err = ((lse[:1] - ref_lse).abs().max().item()
                       if with_lse else 0.0)
            print(f"{label} {name}: max_abs_err {err:.3e}"
                  + (f", lse {lse_err:.3e}" if with_lse else ""))
            ok = ok and err <= MAX_ABS and lse_err <= LSE_ATOL
        del ref_o, ref_lse
        times = {name: [] for name in versions}
        for name in turns:
            times[name].append(cuda_ms(
                lambda: versions[name](q, k, v, o, lse, scale)))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale))
        flops = 4.0 * b * h * d * s * (s + 1) / 2
        result[label] = {
            "shape": [b, h, s, d], "lse": with_lse, "sdpa_ms": sdpa_ms,
            "bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
            "ms": times,
            "tflops": {n: flops / statistics.median(t) / 1e9
                       for n, t in times.items()}}
        print(f"{label}: " + ", ".join(
            f"{n} {' / '.join(f'{x:.3f}' for x in t)} ms"
            for n, t in times.items()) + f", SDPA {sdpa_ms:.3f} ms")
        del q, k, v, o, lse, qt, kt, vt
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
