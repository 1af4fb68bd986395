"""Time K2 (``csrc/flash_attn_bwd_dkv.cu``) and K3
(``csrc/flash_attn_bwd_dq.cu``) against other versions of their sources,
in turns, on one card.

    python -m tpu_cluster_torch.kernels.compare_bwd --export REV DIR
    python -m tpu_cluster_torch.kernels.compare_bwd DIR [DIR ...]

The first form runs where the git history is: it writes every ``csrc``
file of revision REV (for example ``HEAD``, the parent of a change) into
DIR, such as ``build/kernels/parent``. The second runs on the card. Each
DIR holds another ``flash_attn_bwd_dkv.cu`` and/or ``flash_attn_bwd_dq.cu``
with the headers they include; each is built with the port's nvcc flags
into ``DIR/lib<name>.so``. At the training shape (B1 H16 S8192 D256, lse
from the current K1, di = rowsum(o * dO)) every version is first checked
against the plain version (with ``chip_smoke.py``'s relative tolerances),
then timed with CUDA events (median of 20 launches after 3 warm-ups) in
turns: the other versions, the current source twice, the other versions
in reverse order. One ``torch.autograd.grad`` of
``F.scaled_dot_product_attention`` (dQ, dK and dV in one call) on the same
tensors is timed beside them as the yardstick. Prints the card's name and
power limit, each version's ptxas summary, whether each of its kernel
instances compiles to the current source's machine code
(``compare_fwd.same_code``) and one JSON line of times; exits non-zero
if a version disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from . import _build
from . import flash_attention as fa
from .compare_fwd import build_other, cuda_ms, export_sources, power_line, \
    same_code, summary

SHAPE = (1, 16, 8192, 256)  # B, H, S, D: the training shape
KERNELS = ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")
# As chip_smoke.py: relative to the plain magnitude, one bf16 ulp at the
# largest value (max) and far below it (mean).
BWD_MAX_REL = 1e-2
BWD_MEAN_REL = 1e-3
# The plain versions' f32 [B, H, S, S] intermediates: heads at a time.
PLAIN_GROUP_BYTES = 2 ** 31
PEAK_BF16_FLOPS = 989e12
PRODUCTS = {"flash_attn_bwd_dkv": 4, "flash_attn_bwd_dq": 3}


def launcher(lib: ctypes.CDLL, name: str):
    """``run(q, k, v, do, lse, di, *outs, scale)`` through the C entry
    point ``name`` of ``lib`` on the current stream."""
    fn = getattr(lib, name)
    n_ptr, n_strided = fa._SIGNATURES[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                   + [ctypes.c_int64] * (3 * n_strided)
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int

    def run(q, k, v, do, lse, di, *outs, scale):
        stream = torch.cuda.current_stream().cuda_stream
        strided = (q, k, v, do, *outs)
        strides = [s for x in strided for s in x.stride()[:3]]
        err = fn(*(x.data_ptr() for x in (q, k, v, do, lse, di, *outs)),
                 *q.shape, *strides, scale, stream, 0)
        if err != 0:
            raise RuntimeError(f"{name} launch failed ({err})")
    return run


def plain(name: str, inputs, scale: float):
    """The plain version of ``name`` over groups of heads: [dk, dv] or
    [dq]."""
    q = inputs[0]
    batch, seq, heads, _ = q.shape
    group = max(1, min(heads, PLAIN_GROUP_BYTES // (batch * seq * seq * 4)))
    fn = (fa.flash_attention_bwd_dkv_reference
          if name == "flash_attn_bwd_dkv" else
          fa.flash_attention_bwd_dq_reference)
    parts = []
    for h in range(0, heads, group):
        cut = [x[:, :, h:h + group] if x.dim() == 4 else x[:, h:h + group]
               for x in inputs]
        out = fn(*cut, scale)
        parts.append(out if isinstance(out, tuple) else (out,))
    return [torch.cat(ps, dim=2) for ps in zip(*parts)]


def main(argv) -> int:
    if argv[:1] == ["--export"]:
        if len(argv) != 3:
            print("usage: compare_bwd --export REV DIR", file=sys.stderr)
            return 2
        export_sources(argv[1], Path(argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("compare_bwd: no CUDA device", file=sys.stderr)
        return 2
    print(power_line())
    _build.build(["flash_attn_fwd", *KERNELS])
    versions = {name: {} for name in KERNELS}
    for name in KERNELS:
        summary("current", _build.log_path(name).read_text())
        versions[name]["current"] = launcher(_build.load(name), name)
    same = {}
    for arg in argv:
        for name in KERNELS:
            if (Path(arg) / f"{name}.cu").exists():
                versions[name][arg] = launcher(
                    build_other(Path(arg), name), name)
                same[f"{arg}:{name}"] = same_code(
                    name, str(Path(arg) / f"lib{name}.so"))
                print(f"{arg} {name}: same machine code as the current "
                      f"source: {same[f'{arg}:{name}']}")

    b, h, s, d = SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_with_lse(q, k, v, scale)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    inputs = (q, k, v, do, lse, di)
    outs = {"flash_attn_bwd_dkv": (torch.empty_like(k), torch.empty_like(v)),
            "flash_attn_bwd_dq": (torch.empty_like(q),)}

    ok = True
    for name in KERNELS:
        want = plain(name, inputs, scale)
        for label, run in versions[name].items():
            run(*inputs, *outs[name], scale=scale)
            torch.cuda.synchronize()
            for got, ref in zip(outs[name], want):
                err = (got.float() - ref.float()).abs()
                max_rel = err.max().item() / ref.float().abs().max().item()
                mean_rel = (err.mean().item()
                            / ref.float().abs().mean().item())
                print(f"{name} {label}: max_abs/max|plain| {max_rel:.3e}, "
                      f"mean_abs/mean|plain| {mean_rel:.3e}")
                ok = ok and max_rel <= BWD_MAX_REL and mean_rel <= BWD_MEAN_REL
        del want
        torch.cuda.empty_cache()

    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                          scale=scale)
    dot = do.transpose(1, 2)
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa, (qt, kt, vt), dot, retain_graph=True))
    product = 2.0 * b * h * d * s * (s + 1) / 2
    result = {"shape": [b, h, s, d], "sdpa_bwd_ms": sdpa_ms,
              "same_code": same}
    for name in KERNELS:
        others = [label for label in versions[name] if label != "current"]
        times = {label: [] for label in versions[name]}
        for label in others + ["current", "current"] + others[::-1]:
            run = versions[name][label]
            times[label].append(cuda_ms(
                lambda: run(*inputs, *outs[name], scale=scale)))
        flops = PRODUCTS[name] * product
        result[name] = {
            "bound_ms": flops / PEAK_BF16_FLOPS * 1e3, "ms": times,
            "tflops": {label: flops / statistics.median(t) / 1e9
                       for label, t in times.items()}}
        print(f"{name}: " + ", ".join(
            f"{label} {' / '.join(f'{x:.3f}' for x in t)} ms"
            for label, t in times.items()) + f", SDPA backward {sdpa_ms:.3f} ms")
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
