#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``tpu_cluster_torch``) on one
NVIDIA card. Run from the repository root: ``python3 chip_smoke.py``.

It drives the port's main paths with the burn-in transformer at GPT-J
block width (d4096, f16384, h16, vocab 8192), seq 8192, random weights
from seed 0 — the serving engine answering HTTP requests with 4 slots,
``burnin.run`` training at batch 1, the sharded step at mesh (1, 1), and
``burnin.timed_steps`` timing that training — then the validation Job's
entry point, the sharded bench arms (``shardbench``), the flash crossover
sweep at both head widths, and the host side (discovery, labels, the
rendered validation Jobs), and holds every kernel on those paths against
its plain PyTorch version on the card.
Phases, each fatal when it fails:

1. device: name, and name and power limit as nvidia-smi reports them;
   the card's catalogue entry (``tpu_cluster_torch/topology.py``), whose
   data-sheet peaks every bound and MFU below divides by;
2. build: every kernel from ``tpu_cluster_torch/csrc`` with nvcc, one
   process per source, all started together; ptxas's registers and
   spills (none allowed) and each launch's shared memory; the machine
   code of every instance of K1, K2 and K3 must hold wgmma (``HGMMA``)
   and TMA load (``UTMALDG``) instructions;
3. kernels: K1 (forward) against its plain version at the stated shapes
   and tolerances, and its time at the serving shape of each head width
   (256 and 128) beside its bound, the plain version's time and one
   PyTorch library call's time;
4. backward kernels: K1's lse, K2 (dK, dV) and K3 (dQ) against their
   plain versions at the stated shapes and tolerances, and their times at
   the training shape of each head width beside their bounds, the plain
   versions' times and one PyTorch library call's time;
   The LM head: its tensor-core route (``burnin.lm_head``, a bf16
   cuBLAS product with f32 output, and split-cotangent gradients) against
   the f32 product of the up-cast operands at the training shape, within
   the stated bounds; its kernels by name (a bf16 tensor-core GEMM, no
   f32 GEMM);
5. serving: ``ServingServer`` answers concurrent ``POST /v1/generate``
   requests; the kernel launch counts of that run must cover the engine's
   iterations; the metrics scrape must agree with the engine; one
   request's logits are recomputed with the plain attention path and
   compared with the kernel path;
6. training: ``burnin.run`` takes a few SGD steps on the flash path;
   the losses must be finite and decrease, and K1, K2 and K3 must each
   launch once a step; one step's per-parameter gradients on the flash
   path are compared with the plain ("xla") attention path's; ms per
   step, tokens/s and peak device memory; ``run`` reports mesh (1, 1),
   one device, one process. Then the sharded step: ``make_sharded_step``
   at mesh (1, 1) over a one-rank NCCL group must match ``train_step``'s
   losses over the same steps and launch K1, K2 and K3 once a step;
7. timed: ``burnin.flops_per_step`` of the training configuration must
   equal the closed-form model count; ``burnin.timed_steps`` at that
   configuration, inside a duty-cycle and a tensorcore window, must
   launch K1, K2 and K3 once a step it ran (warm-up pair included) and
   read an MFU of at most 1 against the catalogue's peak; TFLOP/s, MFU,
   tokens/s and its step time beside the training phase's;
8. metrics: ``runtime_metrics.write`` inside those windows must publish
   the card's HBM in use (> 0) and capacity (``mem_get_info``), a duty
   cycle above 0 and a tensorcore utilization in (0, 100];
9. validate: ``validate.main`` for device-query, suite, matmul, psum
   (NCCL over the card's one rank) and burnin must each exit 0 with
   ``ok``;
10. shardbench: ``shardbench.main`` on the card (every arm on mesh
   (1, 1) of the one card, each on the attention the crossover selector
   picks; every arm on the kernels launches K1, K2 and K3 once a step):
   no arm may fail; each arm's TFLOP/s and MFU beside the card's name
   and power limit; the collectives roofline of one rank is printed as
   no link measured;
11. profile: device time by kernel for one decode iteration and for one
   training step; neither may run an f32 GEMM (``sm80_xmma_gemm_f32f32``,
   ``simt_sgemm``);
12. crossover (``tpu_cluster_torch/kernels/crossover.py``): at both head
   widths, flash against ``xla`` logits and training gradients at one
   seq; then the sweep of seq 256 to 8192 on the serving and training
   paths, ``xla`` and flash in turns, one row a point beside the card's
   name and power limit; the seq the rule picks on this run beside
   ``FLASH_CROSSOVER_SEQ``; beside the grid, the training shape of
   ``shardbench``'s dp and mp arms (s512 b8 at d_head 256). Fails if
   flash loses to ``xla`` by more than the spread at the constant or
   above, or if a point launched K1, K2 or K3 otherwise than once a
   flash call;
13. host: the machine's ``/dev/nvidia*`` nodes (at least as many as the
   cards torch sees), the node labels of the card's host layout
   (computed, and from the labeler's CLI, whose ``GpuReady`` condition is
   printed beside the card count), and the validation Jobs
   rendered for that layout, whose device-query and vector-add
   containers' command and args run here on the card and must exit 0
   with ``ok``.

The line before the last is a JSON object of the kernels' numbers; the
last is ``{"ok": true, "device": {...}}``. Without a card, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

# the flash path against the "xla" path: tolerances and error measure of
# the crossover drive, whose module states their reasons
from tpu_cluster_torch.kernels.crossover import (GRAD_MAX_REL, GRAD_MEAN_REL,
                                                 LOGIT_ATOL, LOSS_ATOL,
                                                 rel_errors)

SEED = 0
# (B, H, S, D) of the kernel checks; those at S = 8192 are the serving
# shapes of both head widths (standard_config, bench_config), where the
# kernel is also timed. The two with S = 64 mod 128 leave K1's last
# 128-row query tile half past S.
CHECK_SHAPES = ((1, 16, 2048, 256), (2, 8, 1024, 128), (2, 4, 576, 128),
                (2, 3, 1088, 256), (4, 16, 8192, 256), (4, 16, 8192, 128))
FULL_SEQ = 8192
# Kernel against its plain version, bf16 outputs: the running max rounds
# P to bf16 differently from the plain version's single max, so a value
# may land one bf16 ulp away (1.6e-2 at magnitudes in [2, 4)); the mean
# error must stay far below that.
KERNEL_MAX_ABS = 1.6e-2
KERNEL_MEAN_ABS = 2e-4
# (B, H, S, D) of the backward checks; those at S = 8192 are the training
# shapes of both head widths, where the kernels are also timed.
BWD_SHAPES = ((1, 16, 2048, 256), (2, 8, 1024, 128), (2, 4, 576, 128),
              (2, 3, 1088, 256), (1, 16, 8192, 256), (1, 16, 8192, 128))
# K1's lse (f32) against the plain version's: the running max and exp2
# against one max and exp, f32 rounding of values below 20.
LSE_ATOL = 1e-4
# K2's and K3's bf16 outputs against their plain versions', relative to
# the plain magnitude (each gradient sums up to S terms): the kernels and
# the plain versions share every rounding to bf16 (P and dS before their
# products, the outputs) and differ only in f32 summation order and exp,
# which may move one of those roundings by one ulp: max-abs within 1e-2 of
# max|plain| (one ulp at the largest magnitude is at most 2^-7 of it),
# mean-abs within 1e-3 of mean|plain|. exp(s - lse) against upstream's
# exp(s - m) / l differs by f32 rounding only.
BWD_MAX_REL = 1e-2
BWD_MEAN_REL = 1e-3
# The plain backward materialises f32 [B, H, S, S] tensors; it runs over
# groups of heads whose such tensor stays within this many bytes.
PLAIN_GROUP_BYTES = 2 ** 31
# The training drive: burnin.standard_config's width at seq 8192, batch 1
# (the reference's long-context row), a few SGD steps.
TRAIN_SEQ = 8192
TRAIN_BATCH = 1
TRAIN_STEPS = 5
# The timed drive: burnin.timed_steps at the training configuration,
# reps pairs of TIMED_STEPS and 3 * TIMED_STEPS steps after a warm-up pair.
TIMED_STEPS = 5
TIMED_REPS = 3
# The LM head at the training shape, tensor cores against the f32 product
# of the up-cast operands. Logits: both are f32 sums of the same D = 4096
# exact products in other orders. They are held to sqrt(D) * u * sum|y w|
# (u = 2^-24), the probabilistic bound on the rounding error of a sum of
# D terms (Higham and Mary 2019: errors of either sign grow as sqrt(D), the
# worst case as D). The two f32 orders came to 0.248 of it on an H100 at
# this shape; logits rounded to bf16 land 103 times outside it, and the
# run shows that control failing. Gradients: both
# round to bf16 once, after f32 sums that differ by far less than a bf16
# ulp, so every element lies within one ulp at the largest magnitude, and
# at most HEAD_GRAD_MISMATCH of the elements round otherwise than the f32
# route's. The split cotangent (hi + lo, ~16 bits) gave 0.52% on an H100
# at this shape; its high half alone (8 bits) gave 42.6%, and the run
# shows that control failing too.
HEAD_GRAD_MISMATCH = 0.02
# f32 GEMM kernels the head ran on before it moved to the tensor cores;
# none may remain in a decode or a training step.
F32_GEMMS = ("sm80_xmma_gemm_f32f32", "simt_sgemm")
# The serving drive: burnin.standard_config's width at this context.
SERVING_SEQ = 8192
SERVING_SLOTS = 4
NEW_TOKENS = 8
PROMPT_LENS = (64, 1200, 2500, 3700, 4900, 6000)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, warmup: int, reps: int) -> float:
    """Median milliseconds of ``fn`` between CUDA events, after warm-up."""
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


def device_phase(torch):
    """The card's name, and its catalogue entry (data-sheet peaks: dense
    bf16 rate and HBM bandwidth), which every bound below divides by."""
    from tpu_cluster_torch import topology

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"device: {name}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
    acc = topology.from_device_name(name)
    check(acc is not None, f"no catalogue entry for {name!r}: no peak to "
                           f"bound the kernels by")
    print(f"catalogue: {acc.name}, data sheet {acc.peak_bf16_tflops:g} "
          f"TFLOP/s dense bf16, {acc.hbm_bytes_per_s / 1e12:g} TB/s HBM")
    return name, acc, smi_line


def sass_counts(lib: str, ops) -> dict:
    """Per kernel of the library ``lib``, how many of its SASS
    instructions start with each of ``ops`` (cuobjdump -sass)."""
    from tpu_cluster_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict = {}
    kernel = None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            counts[kernel] = dict.fromkeys(ops, 0)
        elif kernel is not None and "*/" in line:
            # "/*0a30*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], ..."
            words = line.split("*/", 1)[1].split()
            opcode = words[0] if words else ""
            if opcode.startswith("@"):  # predicate guard
                opcode = words[1] if len(words) > 1 else ""
            for op in ops:
                counts[kernel][op] += opcode.startswith(op)
    return counts


def build_phase() -> None:
    """Build every kernel; fail on a ptxas spill in any instance, and
    unless every instance's machine code holds wgmma (``HGMMA``) and TMA
    loads (``UTMALDG``). Prints each instance's registers and the dynamic
    shared memory its launch asks for."""
    import ctypes

    from tpu_cluster_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {len(_build.SOURCES)} kernel source(s) ready in "
          f"{time.perf_counter() - t0:.1f} s")
    ops = ("HGMMA", "UTMALDG")
    for name in _build.SOURCES:
        for line in _build.log_path(name).read_text().splitlines():
            # the entry line names the instance (template arguments)
            if "entry function" in line or "registers" in line \
                    or "spill" in line or "warning" in line:
                print(f"  {name}: {line.strip()}")
            if "spill" in line:
                check(" 0 bytes spill stores, 0 bytes spill loads" in line,
                      f"{name} spills registers: {line.strip()}")
        lib = ctypes.CDLL(str(_build.library_path(name)))
        smem = {d: lib.flash_attn_smem_bytes(d) for d in (128, 256)}
        print(f"  {name}: dynamic shared memory a launch asks for: "
              + ", ".join(f"D={d} {n} bytes" for d, n in smem.items()))
        counts = sass_counts(str(_build.library_path(name)), ops)
        kernels = {k: v for k, v in counts.items() if f"{name}_kernel" in k}
        for kernel, n in kernels.items():
            # the mangled name holds the instance: ...kernelILi256ELi64E...
            args = re.findall(r"Li(\d+)E", kernel.split("_kernel", 1)[1])
            print(f"  {name}_kernel<{', '.join(args)}> SASS: "
                  + ", ".join(f"{op} x{n[op]}" for op in ops))
        check(len(kernels) == 2  # D = 128 and 256
              and all(n[op] > 0 for n in kernels.values() for op in ops),
              f"{name} instances without wgmma or TMA loads: {kernels}")


def flash_phase(torch, acc) -> dict:
    """The flash-attention kernel against its plain version at every
    check shape; timings at the serving shapes. Returns the record of
    each, by head width."""
    import torch.nn.functional as F

    from tpu_cluster_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = {}
    for b, h, s, d in CHECK_SHAPES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        out = fa.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "kernel output not finite")
        # at the serving shape compare batch row 0: the plain version's
        # f32 [H, S, S] scores are then ~4 GB
        rows = 1 if s >= 8192 else b
        ref = fa.flash_attention_reference(q[:rows], k[:rows], v[:rows],
                                           scale)
        err = (out[:rows].float() - ref.float()).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        print(f"flash_attn_fwd B{b} H{h} S{s} D{d} (rows compared: {rows}): "
              f"max_abs_err {max_err:.3e} (tol {KERNEL_MAX_ABS}), "
              f"mean_abs_err {mean_err:.3e} (tol {KERNEL_MEAN_ABS})")
        check(max_err <= KERNEL_MAX_ABS and mean_err <= KERNEL_MEAN_ABS,
              f"kernel disagrees with its plain version at "
              f"B{b} H{h} S{s} D{d}")
        del out, ref, err
        if s != FULL_SEQ:
            continue
        ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, scale),
                     warmup=3, reps=20)
        plain_ms = cuda_ms(torch, lambda: [
            fa.flash_attention_reference(q[i:i + 1], k[i:i + 1],
                                         v[i:i + 1], scale)
            for i in range(b)], warmup=1, reps=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale), warmup=3, reps=20)
        # causal useful work: S(S+1)/2 (query, key) pairs per head, each a
        # D-long product in Q K^T and in P V (2 flops a multiply-add)
        flops = 4.0 * b * h * d * s * (s + 1) / 2
        nbytes = 4.0 * b * s * h * d * 2  # q, k, v read once, o written
        flop_ms = flops / (acc.peak_bf16_tflops * 1e12) * 1e3
        byte_ms = nbytes / acc.hbm_bytes_per_s * 1e3
        records[d] = record = {
            "name": "flash_attn_fwd", "route": "cuda",
            "source": "tpu_cluster_torch/csrc/flash_attn_fwd.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py"
                        ":758 (_flash_attention_impl, reached from "
                        "tpu_cluster/workloads/burnin.py:220)",
            "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": library_ms, "tflops": flops / ms / 1e9,
        }
        print(f"flash_attn_fwd B{b} H{h} S{s} D{d}: kernel {ms:.3f} ms "
              f"({record['tflops']:.1f} TFLOP/s), bound {record['bound_ms']:.3f}"
              f" ms ({record['bound_by']}), plain {plain_ms:.3f} ms, "
              f"SDPA {library_ms:.3f} ms")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return records


def by_heads(torch, fn, tensors, scale: float):
    """A plain version over groups of heads (its f32 [B, H, S, S]
    intermediates stay within PLAIN_GROUP_BYTES), joined along the head
    axis: [B, S, H, D] tensors split on dim 2, [B, H, S] on dim 1."""
    batch, seq, heads, _ = tensors[0].shape
    group = max(1, min(heads, PLAIN_GROUP_BYTES // (batch * seq * seq * 4)))

    def cut(x, h):
        return x[:, :, h:h + group] if x.dim() == 4 else x[:, h:h + group]

    parts = [fn(*(cut(x, h) for x in tensors), scale)
             for h in range(0, heads, group)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=2)
    return tuple(torch.cat(ps, dim=2 if ps[0].dim() == 4 else 1)
                 for ps in zip(*parts))


def backward_phase(torch, acc) -> dict:
    """K1's lse, K2 and K3 against their plain versions at every backward
    check shape; timings at the training shapes. Returns, by head width,
    the K2 and K3 records and K1's numbers at the training shape."""
    import torch.nn.functional as F

    from tpu_cluster_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    out = {}
    for b, h, s, d in BWD_SHAPES:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        scale = d ** -0.5
        tag = f"B{b} H{h} S{s} D{d}"
        o, lse = fa.flash_attention_with_lse(q, k, v, scale)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, scale)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, scale)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x).all()) for x in (lse, dq, dk, dv)),
              f"backward kernel output not finite at {tag}")

        ref_o, ref_lse = by_heads(
            torch, lambda *a: fa.flash_attention_reference(*a, True),
            (q, k, v), scale)
        lse_err = (lse - ref_lse).abs().max().item()
        o_err = (o.float() - ref_o.float()).abs().max().item()
        print(f"flash_attn_fwd lse {tag}: max_abs_err {lse_err:.3e} "
              f"(tol {LSE_ATOL}); o max_abs_err {o_err:.3e} "
              f"(tol {KERNEL_MAX_ABS})")
        check(lse_err <= LSE_ATOL and o_err <= KERNEL_MAX_ABS,
              f"K1 with lse disagrees with its plain version at {tag}")
        del ref_o, ref_lse
        inputs = (q, k, v, do, lse, di)
        ref_dk, ref_dv = by_heads(torch, fa.flash_attention_bwd_dkv_reference,
                                  inputs, scale)
        ref_dq = by_heads(torch, fa.flash_attention_bwd_dq_reference,
                          inputs, scale)
        errs = {}
        for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                                ("dv", dv, ref_dv)):
            errs[name], max_rel, mean_rel = rel_errors(got, want)
            print(f"flash_attn_bwd {name} {tag}: max_abs/max|plain| "
                  f"{max_rel:.3e} (tol {BWD_MAX_REL}), mean_abs/mean|plain| "
                  f"{mean_rel:.3e} (tol {BWD_MEAN_REL})")
            check(max_rel <= BWD_MAX_REL and mean_rel <= BWD_MEAN_REL,
                  f"{name} disagrees with its plain version at {tag}")
        del ref_dq, ref_dk, ref_dv, dq, dk, dv
        if s != FULL_SEQ:
            del q, k, v, do, o, lse, di
            torch.cuda.empty_cache()
            continue

        # causal useful work: S(S+1)/2 (query, key) pairs per head, each a
        # D-long product (2 flops a multiply-add) in every product
        product = 2.0 * b * h * d * s * (s + 1) / 2
        tensor_bytes = b * s * h * d * 2.0
        row_bytes = b * h * s * 4.0

        def bound(flops, nbytes):
            flop_ms = flops / (acc.peak_bf16_tflops * 1e12) * 1e3
            byte_ms = nbytes / acc.hbm_bytes_per_s * 1e3
            return (max(flop_ms, byte_ms),
                    "operations" if flop_ms >= byte_ms else "bytes")

        fwd_ms = cuda_ms(torch, lambda: fa.flash_attention_with_lse(
            q, k, v, scale), warmup=3, reps=10)
        fwd_plain_ms = cuda_ms(torch, lambda: by_heads(
            torch, lambda *a: fa.flash_attention_reference(*a, True),
            (q, k, v), scale), warmup=1, reps=2)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        with torch.no_grad():
            fwd_lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale), warmup=3, reps=10)
        fwd_bound, fwd_by = bound(2 * product, 4 * tensor_bytes + row_bytes)
        out[d] = {}
        out[d]["k1_training"] = {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                              "bound_ms": fwd_bound, "bound_by": fwd_by,
                              "library_ms": fwd_lib_ms,
                              "tflops": 2 * product / fwd_ms / 1e9}
        print(f"flash_attn_fwd with lse {tag}: kernel {fwd_ms:.3f} ms "
              f"({2 * product / fwd_ms / 1e9:.1f} TFLOP/s), bound "
              f"{fwd_bound:.3f} ms ({fwd_by}), plain {fwd_plain_ms:.3f} ms, "
              f"SDPA {fwd_lib_ms:.3f} ms")

        # the yardstick for the K2 + K3 pair: SDPA's backward, dQ, dK and
        # dV together, on the same tensors (the port never calls it)
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=scale)
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qt, kt, vt), dot, retain_graph=True), warmup=3, reps=10)
        kernels = (
            ("flash_attn_bwd_dkv", "_flash_attention_bwd_dkv", ":1121",
             lambda: fa.flash_attention_bwd_dkv(*inputs, scale),
             lambda: by_heads(torch, fa.flash_attention_bwd_dkv_reference,
                              inputs, scale),
             4, 6, max(errs["dk"], errs["dv"])),
            ("flash_attn_bwd_dq", "_flash_attention_bwd_dq", ":1456",
             lambda: fa.flash_attention_bwd_dq(*inputs, scale),
             lambda: by_heads(torch, fa.flash_attention_bwd_dq_reference,
                              inputs, scale),
             3, 5, errs["dq"]),
        )
        for name, upstream, line, run, plain, n_products, n_tensors, err \
                in kernels:
            ms = cuda_ms(torch, run, warmup=3, reps=10)
            plain_ms = cuda_ms(torch, plain, warmup=1, reps=2)
            flops = n_products * product
            bound_ms, bound_by = bound(
                flops, n_tensors * tensor_bytes + 2 * row_bytes)
            out[d][name] = {
                "name": name, "route": "cuda",
                "source": f"tpu_cluster_torch/csrc/{name}.cu",
                "replaces": "jax/experimental/pallas/ops/tpu/"
                            f"flash_attention.py{line} ({upstream}, "
                            "reached from the VJP of "
                            "tpu_cluster/workloads/burnin.py:220)",
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
            }
            print(f"{name} {tag}: kernel {ms:.3f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.3f} "
                  f"ms ({bound_by}), plain {plain_ms:.3f} ms, SDPA backward "
                  f"(dQ, dK, dV) {library_ms:.3f} ms")
        del sdpa, qt, kt, vt, dot, q, k, v, do, o, lse, di, inputs
        torch.cuda.empty_cache()
    return out


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers (8 significant bits) at |x| > 0."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def head_phase(torch) -> None:
    """The LM head (``burnin.lm_head``) at the training shape, forward and
    both gradients, against the f32 product of the up-cast operands (the
    CPU route) on the same inputs; its time beside that route's; its
    kernels by name."""
    from tpu_cluster_torch.workloads import burnin

    std = burnin.standard_config()
    n, d, v = TRAIN_BATCH * TRAIN_SEQ, std.d_model, std.vocab
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    y = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(d, v, generator=gen, device="cuda") * d ** -0.5
         ).bfloat16()
    # a cotangent of the cross-entropy's scale, (softmax - onehot) / N
    g = torch.randn(n, v, generator=gen, device="cuda") / n
    yl, wl = y.clone().requires_grad_(), w.clone().requires_grad_()

    def head():
        return torch.autograd.grad(burnin.lm_head(yl, wl), (yl, wl), g)

    def plain():
        return torch.autograd.grad(yl.float() @ wl.float(), (yl, wl), g)

    logits = burnin.lm_head(y, w)
    dy, dw = head()
    torch.cuda.synchronize()
    check(logits.dtype == torch.float32 and dy.dtype == dw.dtype
          == torch.bfloat16, "LM head dtypes")
    want = y.float() @ w.float()
    bound = math.sqrt(d) * 2.0 ** -24 * (y.float().abs() @ w.float().abs())
    err = (logits - want).abs()
    ratio = (err / bound).max().item()
    control = ((want.bfloat16().float() - want).abs() / bound).max().item()
    print(f"lm_head [{n}, {d}] x [{d}, {v}]: logits max_abs_err "
          f"{err.max().item():.3e}, largest err / (sqrt(D) u sum|y w|) "
          f"{ratio:.3e} (tol 1); control, the f32 product rounded to bf16: "
          f"{control:.3e} (must exceed 1)")
    check(ratio <= 1.0, "LM head logits outside the f32 summation bound")
    check(control > 1.0, "the logits bound does not reject bf16 logits")
    del logits, want, err, bound
    want_dy, want_dw = plain()
    # the control: the gradients from the high half of the cotangent alone
    hi = g.to(torch.bfloat16)
    f32 = torch.float32
    hi_dy = torch.mm(hi, w.t(), out_dtype=f32).to(torch.bfloat16)
    hi_dw = torch.mm(y.t(), hi, out_dtype=f32).to(torch.bfloat16)
    for name, got, ref, hi_only in (("dX", dy, want_dy, hi_dy),
                                    ("dW", dw, want_dw, hi_dw)):
        gerr = (got.float() - ref.float()).abs().max().item()
        ulp = bf16_ulp(ref.float().abs().max().item())
        frac = (got != ref).float().mean().item()
        hi_frac = (hi_only != ref).float().mean().item()
        print(f"lm_head {name}: max_abs_err {gerr:.3e} (tol one bf16 ulp "
              f"at the largest magnitude, {ulp:.3e}); elements rounded "
              f"otherwise than the f32 route {frac:.4%} (tol "
              f"{HEAD_GRAD_MISMATCH:.0%}); control, the high half of the "
              f"cotangent alone: {hi_frac:.4%} (must exceed the tol)")
        check(gerr <= ulp, f"LM head {name} disagrees with the f32 route")
        check(frac <= HEAD_GRAD_MISMATCH,
              f"LM head {name} rounds otherwise than the f32 route")
        check(hi_frac > HEAD_GRAD_MISMATCH,
              f"the {name} check does not reject an 8-bit cotangent")
    del dy, dw, want_dy, want_dw, hi, hi_dy, hi_dw
    fwd_ms = cuda_ms(torch, lambda: burnin.lm_head(y, w), warmup=3,
                     reps=10)
    fwd_plain_ms = cuda_ms(torch, lambda: y.float() @ w.float(), warmup=1,
                           reps=3)
    step_ms = cuda_ms(torch, head, warmup=3, reps=10)
    step_plain_ms = cuda_ms(torch, plain, warmup=1, reps=3)
    flops = 2.0 * n * d * v
    print(f"lm_head: forward {fwd_ms:.3f} ms ({flops / fwd_ms / 1e9:.1f} "
          f"TFLOP/s) against the f32 route's {fwd_plain_ms:.3f} ms; forward "
          f"and both gradients {step_ms:.3f} ms against {step_plain_ms:.3f}"
          f" ms")
    names = profile(torch, "the LM head, forward and both gradients", head,
                    top=8)
    gemms = [k for k in names if "gemm" in k.lower() or "nvjet" in k]
    print(f"lm_head GEMM kernels: {gemms}")
    check(bool(gemms) and not any(f in k for k in names for f in F32_GEMMS),
          f"LM head not on bf16 tensor-core GEMMs: {names}")
    del y, w, g, yl, wl
    torch.cuda.empty_cache()


def _post(url: str, prompt, replies, i: int) -> None:
    body = json.dumps({"prompt": prompt}).encode()
    req = urllib.request.Request(url + "/v1/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            replies[i] = (resp.status, json.loads(resp.read().decode()))
    except urllib.error.HTTPError as err:
        replies[i] = (err.code, {})


def serving_phase(torch) -> dict:
    import numpy as np
    from dataclasses import replace

    from tpu_cluster_torch import telemetry
    from tpu_cluster_torch.kernels import flash_attention as fa
    from tpu_cluster_torch.workloads import burnin, serving

    std = burnin.standard_config()
    cfg = serving.ServingConfig(
        vocab=std.vocab, d_model=std.d_model, d_ff=std.d_ff,
        n_heads=std.n_heads, seq=SERVING_SEQ, slots=SERVING_SLOTS,
        max_new_tokens=NEW_TOKENS, default_deadline_s=600.0)
    engine = serving.InferenceEngine(cfg, telemetry=telemetry.Telemetry())
    mcfg = engine.model_config()
    check(mcfg.attention == "flash",
          f"serving config selected {mcfg.attention!r}, not the kernel")
    t0 = time.perf_counter()
    # Build the weights before the clock starts. The engine thread has not
    # started, so nothing else touches the engine's model state yet.
    params, decode, _ = engine._ensure_model()
    torch.cuda.synchronize()
    print(f"serving: model built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in params.values()) / 1e6:.0f} M bf16 "
          f"parameters)")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    replies = [None] * len(prompts)
    server = serving.ServingServer(engine)

    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0  # count the main path's run only
    server.start()
    try:
        t0 = time.perf_counter()
        posts = [threading.Thread(target=_post,
                                  args=(server.url, p, replies, i))
                 for i, p in enumerate(prompts)]
        for th in posts:
            th.start()
        for th in posts:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        iterations, decoded = engine.iterations, engine.decoded_tokens
        with urllib.request.urlopen(server.metrics_url, timeout=60) as resp:
            metrics_text = resp.read().decode()
    finally:
        server.stop()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    codes = [r[0] if r else None for r in replies]
    check(codes == [200] * len(prompts), f"HTTP codes {codes}")
    counts = [len(r[1]["tokens"]) for r in replies]
    check(counts == [cfg.max_new_tokens] * len(prompts),
          f"token counts {counts}")
    scraped = [line for line in metrics_text.splitlines()
               if line.startswith("tpu_serving_tokens_total ")]
    check(len(scraped) == 1 and float(scraped[0].split()[1]) == decoded,
          f"metrics {scraped} vs decoded_tokens {decoded}")
    check(iterations > 0 and launches == iterations,
          f"flash launches {launches} vs engine iterations {iterations} "
          f"(one attention layer per forward)")
    print(f"serving: {len(prompts)} requests (prompts {list(PROMPT_LENS)} "
          f"tokens) all 200, {decoded} tokens in {iterations} iterations, "
          f"{wall:.3f} s wall: {wall / iterations * 1e3:.1f} ms/iteration, "
          f"{decoded / wall:.2f} decoded tokens/s; flash launches "
          f"{launches}; peak device memory {peak_gib:.1f} GiB")

    # teacher forcing on the longest request: its history in a zero-padded
    # row, logits at each iteration's position, kernel path vs plain path
    prompt, tokens = prompts[-1], replies[-1][1]["tokens"]
    row = np.zeros((1, cfg.seq), np.int64)
    history = prompt + tokens[:-1]
    row[0, :len(history)] = history
    positions = [len(prompt) - 1 + i for i in range(len(tokens))]
    one = replace(mcfg, batch=1)
    with torch.inference_mode():
        toks = torch.from_numpy(row).cuda()
        flash_logits = burnin.forward(params, toks, one)
        check(tuple(flash_logits.shape) == (1, cfg.seq, cfg.vocab)
              and bool(torch.isfinite(flash_logits).all()),
              "flash-path logits malformed")
        flash_logits = flash_logits[0, positions].float().cpu().numpy()
        plain_logits = burnin.forward(params, toks,
                                      replace(one, attention="xla"))
        plain_logits = plain_logits[0, positions].float().cpu().numpy()
    err = float(np.abs(flash_logits - plain_logits).max())
    top2 = np.sort(flash_logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL
    agree = [int(flash_logits[i].argmax()) == tok
             for i, tok in enumerate(tokens) if clear[i]]
    print(f"serving: teacher-forced logits of the {len(prompt)}-token "
          f"request, flash vs plain attention: max_abs_err {err:.3e} "
          f"(tol {LOGIT_ATOL}); served tokens match the batch-1 argmax at "
          f"{sum(agree)}/{len(agree)} well-separated positions")
    check(err < LOGIT_ATOL, "flash path disagrees with the plain path")
    check(all(agree), "served tokens disagree with the teacher-forced argmax")
    return {"launches": launches, "params": params, "decode": decode,
            "engine": engine}


def training_phase(torch) -> dict:
    """``burnin.run`` on the flash path at the standard width, seq 8192,
    batch 1; launch counts of that run; gradients against the "xla" path;
    ms per step. Returns the launch counts and the step's inputs."""
    from dataclasses import replace

    from tpu_cluster_torch.kernels import flash_attention as fa
    from tpu_cluster_torch.workloads import burnin

    cfg = replace(burnin.standard_config(), seq=TRAIN_SEQ, batch=TRAIN_BATCH)
    attention = burnin.select_attention(cfg, "cuda")
    check(attention == "flash",
          f"training config selected {attention!r}, not the kernels")
    cfg = replace(cfg, attention=attention, remat="none")
    kernels = (fa.flash_attention, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)

    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:  # count the main path's run only
        fn.launches = 0
    result = burnin.run(steps=TRAIN_STEPS, cfg=cfg, mesh_shape=(1, 1))
    torch.cuda.synchronize()
    launches = [fn.launches for fn in kernels]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"training: burnin.run d{cfg.d_model} f{cfg.d_ff} h{cfg.n_heads} "
          f"v{cfg.vocab} s{cfg.seq} b{cfg.batch} attention={cfg.attention} "
          f"remat={cfg.remat}: losses {result['losses']}, "
          f"{result['seconds']:.3f} s for {result['steps']} steps, "
          f"loss_decreasing {result['loss_decreasing']}; launches K1 "
          f"{launches[0]}, K2 {launches[1]}, K3 {launches[2]}; peak device "
          f"memory {peak_gib:.1f} GiB")
    check(len(result["losses"]) == TRAIN_STEPS
          and all(math.isfinite(x) for x in result["losses"]),
          f"training losses {result['losses']}")
    check(result["loss_decreasing"] and result["ok"],
          f"training loss did not decrease: {result['losses']}")
    check((result["mesh"], result["devices"], result["processes"])
          == ({"data": 1, "model": 1}, 1, 1),
          f"run reports mesh {result['mesh']}, devices {result['devices']}, "
          f"processes {result['processes']}")
    check(launches == [TRAIN_STEPS] * 3,
          f"launches K1/K2/K3 {launches}, expected {TRAIN_STEPS} each (one "
          f"attention layer, remat none)")

    # the same seeded parameters and tokens as run()
    params, batch = burnin.seeded_inputs(cfg, torch.device("cuda"))
    step_ms = cuda_ms(torch, lambda: burnin.train_step(params, batch, cfg),
                      warmup=1, reps=5)
    tokens_per_s = cfg.batch * cfg.seq / (step_ms / 1e3)
    print(f"training: {step_ms:.3f} ms/step (median of 5 after warm-up, "
          f"CUDA events), {tokens_per_s:.1f} tokens/s")

    loss_f, grads_f = burnin.loss_and_grads(params, batch, cfg)
    torch.cuda.reset_peak_memory_stats()
    loss_x, grads_x = burnin.loss_and_grads(params, batch,
                                            replace(cfg, attention="xla"))
    xla_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_err = abs(loss_f.item() - loss_x.item())
    print(f"training: one step's loss flash {loss_f.item():.6f} vs xla "
          f"{loss_x.item():.6f} (|diff| {loss_err:.2e}, tol "
          f"{LOSS_ATOL}); xla-path peak {xla_peak_gib:.1f} GiB")
    check(loss_err <= LOSS_ATOL, "flash-path loss disagrees with xla")
    for name in grads_x:
        _, max_rel, mean_rel = rel_errors(grads_f[name], grads_x[name])
        print(f"  grad {name:5s} flash vs xla: max_abs/max|xla| "
              f"{max_rel:.3e} (tol {GRAD_MAX_REL}), "
              f"mean_abs/mean|xla| {mean_rel:.3e} (tol "
              f"{GRAD_MEAN_REL})")
        check(max_rel <= GRAD_MAX_REL
              and mean_rel <= GRAD_MEAN_REL,
              f"flash-path gradient of {name} disagrees with the xla path")
    del grads_f, grads_x
    torch.cuda.empty_cache()
    return {"launches": launches, "params": params, "batch": batch,
            "cfg": cfg, "step_ms": step_ms}


def sharded_phase(torch, trained: dict) -> dict:
    """``make_sharded_step`` at mesh (1, 1) over a one-rank NCCL group at
    the training configuration, against ``train_step`` over the same
    steps from the same seeded inputs; launch counts of the sharded run.
    Returns them."""
    from tpu_cluster_torch.kernels import flash_attention as fa
    from tpu_cluster_torch.workloads import burnin, collectives

    cfg = trained["cfg"]
    p, want = trained["params"], []
    for _ in range(TRAIN_STEPS):
        p, loss = burnin.train_step(p, trained["batch"], cfg)
        want.append(loss.item())
    del p
    kernels = (fa.flash_attention, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    with collectives.process_group("cuda") as (_, world, dev):
        mesh = burnin.make_mesh((1, 1), dev)
        step, params, batch = burnin.make_sharded_step(mesh, cfg)
        torch.cuda.synchronize()
        for fn in kernels:  # count the main path's run only
            fn.launches = 0
        got = []
        for _ in range(TRAIN_STEPS):
            params, loss = step(params, batch)
            got.append(loss.item())
        launches = [fn.launches for fn in kernels]
    del params, batch
    torch.cuda.empty_cache()
    err = max(abs(a - b) for a, b in zip(got, want))
    print(f"sharded: make_sharded_step mesh (1, 1), {world} NCCL rank: "
          f"losses {[round(x, 6) for x in got]} against train_step's "
          f"{[round(x, 6) for x in want]} (max |diff| {err:.2e}, tol "
          f"{LOSS_ATOL}); launches K1 {launches[0]}, K2 "
          f"{launches[1]}, K3 {launches[2]}")
    check(err <= LOSS_ATOL, "sharded step's losses disagree with "
                                  "train_step's")
    check(launches == [TRAIN_STEPS] * 3,
          f"sharded launches K1/K2/K3 {launches}, expected {TRAIN_STEPS} "
          f"each")
    return {"launches": launches}


def timed_phase(torch, acc, trained: dict) -> dict:
    """``burnin.timed_steps`` at the training configuration on the flash
    path, inside a duty-cycle and a tensorcore window; its FLOP count
    against the closed form, its launch counts, its MFU; then the metrics
    phase inside the same windows. Returns the launch counts."""
    from tpu_cluster_torch.kernels import flash_attention as fa
    from tpu_cluster_torch.workloads import burnin, runtime_metrics

    cfg = trained["cfg"]
    t0 = time.perf_counter()
    flops = burnin.flops_per_step(cfg)
    count_s = time.perf_counter() - t0
    b, s, d, f, v = cfg.batch, cfg.seq, cfg.d_model, cfg.d_ff, cfg.vocab
    # one block's products, forward (1) and backward (2), attention at
    # full S^2 (Q K^T and P V)
    closed = 3 * (2 * b * s * (4 * d * d + 2 * d * f + d * v)
                  + 4 * b * s * s * d)
    print(f"timed: flops_per_step {flops:,} (closed form {closed:,}), "
          f"counted in {count_s:.2f} s")
    check(flops == closed, f"flops_per_step {flops} != closed form {closed}")

    kernels = (fa.flash_attention, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    with runtime_metrics.duty_cycle_window(), \
            runtime_metrics.tensorcore_window():
        for fn in kernels:  # count the main path's run only
            fn.launches = 0
        result = burnin.timed_steps(cfg, steps=TIMED_STEPS, reps=TIMED_REPS)
        torch.cuda.synchronize()
        launches = [fn.launches for fn in kernels]
        metrics_phase(torch)
    ran = 4 * TIMED_STEPS * (TIMED_REPS + 1)  # lo + hi = 4 steps' worth
    mfu = result["tflops"] / acc.peak_bf16_tflops
    span_steps = 2 * TIMED_STEPS if "tflops_spread" in result \
        else 3 * TIMED_STEPS
    step_ms = result["seconds"] / span_steps * 1e3
    print(f"timed: burnin.timed_steps steps={TIMED_STEPS} reps={TIMED_REPS}: "
          f"{result['tflops']:.2f} TFLOP/s, MFU {mfu:.4f} of the data "
          f"sheet's {acc.peak_bf16_tflops:g}, spread "
          f"{result.get('tflops_spread', result.get('note'))}, "
          f"{result['tokens_per_s']:.1f} tokens/s, points "
          f"{result['points']}; launches K1 {launches[0]}, K2 "
          f"{launches[1]}, K3 {launches[2]} ({ran} steps run)")
    print(f"timed: {step_ms:.3f} ms a step (delta over {span_steps} steps) "
          f"against the training phase's {trained['step_ms']:.3f} ms (CUDA "
          f"events): ratio {step_ms / trained['step_ms']:.4f}")
    check(launches == [ran] * 3,
          f"timed_steps launches K1/K2/K3 {launches}, expected {ran} each")
    check(0 < mfu <= 1.0, f"timed_steps MFU {mfu} outside (0, 1]")
    return {"launches": launches}


def metrics_phase(torch) -> None:
    """``runtime_metrics.write`` into a temporary file, inside the timed
    phase's windows: HBM gauges from the allocator and ``mem_get_info``, and
    measured duty-cycle and tensorcore gauges."""
    import tempfile

    from tpu_cluster_torch.workloads import runtime_metrics

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "metrics.prom")
        with mock.patch.dict(os.environ, {"TPU_METRICS_FILE": path}):
            written = runtime_metrics.write(runtime_metrics.resolved_path())
        check(written == path, f"metrics not written: {written}")
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    values = {}
    for line in lines:
        if not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            values[key] = float(val)
    used = values.get('tpu_hbm_used_bytes{chip="0"}', 0.0)
    limit = values.get('tpu_hbm_limit_bytes{chip="0"}', 0.0)
    duty = values.get('tpu_duty_cycle_percent{chip="0"}', 0.0)
    tc = values.get('tpu_tensorcore_utilization_percent{chip="0"}', 0.0)
    source = values.get('tpu_hbm_source{source="memory_stats"}')
    capacity = torch.cuda.mem_get_info(0)[1]
    print(f"metrics: tpu_hbm_used_bytes {used:.0f}, tpu_hbm_limit_bytes "
          f"{limit:.0f} (mem_get_info {capacity}), source memory_stats "
          f"{source}, tpu_duty_cycle_percent {duty}, "
          f"tpu_tensorcore_utilization_percent {tc}")
    check(used > 0, "tpu_hbm_used_bytes missing or 0")
    check(limit == capacity, "tpu_hbm_limit_bytes is not the card's capacity")
    check(source == 1.0, "HBM gauges not from memory_stats")
    check(duty > 0, "tpu_duty_cycle_percent missing or 0")
    check(0 < tc <= 100, f"tpu_tensorcore_utilization_percent {tc} outside "
                         f"(0, 100]")


def validate_phase(torch) -> None:
    """The validation Job's entry point, in this process, mode by mode."""
    import contextlib
    import io
    import tempfile

    from tpu_cluster_torch.workloads import validate

    runs = (("device-query", [f"--expect-devices={torch.cuda.device_count()}"]),
            ("suite", []), ("matmul", ["--matmul-dim=4096"]), ("psum", []),
            ("burnin", []))
    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(
            os.environ, {"TPU_METRICS_FILE": os.path.join(tmp, "v.prom")}):
        for mode, extra in runs:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = validate.main([f"--mode={mode}", *extra])
            wall = time.perf_counter() - t0
            doc = json.loads(out.getvalue())
            detail = ""
            if mode == "matmul":
                detail = (f", {doc['tflops']:.1f} TFLOP/s bf16 at "
                          f"{doc['m']} (a smoke number: one pass of "
                          f"{doc['iters']} chained products)")
            elif mode == "psum":
                detail = f", {doc['devices']} rank(s)"
            elif mode == "suite":
                detail = f", wall_s {doc['wall_s']:.3f}"
            elif mode == "burnin":
                detail = f", losses {doc['losses']}"
            print(f"validate --mode={mode}: rc {rc}, ok {doc['ok']}, "
                  f"{wall:.2f} s{detail}")
            check(rc == 0 and doc["ok"] is True,
                  f"validate --mode={mode} failed: {doc}")


def shardbench_phase(torch, acc, smi_line: str) -> dict:
    """``shardbench.main`` on the card: the three arms on the one card's
    mesh (1, 1), the collectives roofline of one rank; launch counts of
    that run. Returns them."""
    from tpu_cluster_torch.kernels import flash_attention as fa
    from tpu_cluster_torch.workloads import burnin, shardbench

    kernels = (fa.flash_attention, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    for fn in kernels:  # count the main path's run only
        fn.launches = 0
    t0 = time.perf_counter()
    doc = shardbench.main([])
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    check(doc["platform"] == "cuda" and not doc["tiny"],
          f"shardbench ran platform {doc['platform']} tiny {doc['tiny']}")
    for name, arm in doc["arms"].items():
        check("error" not in arm, f"shardbench arm {name}: {arm}")
        mfu = arm["tflops"] / acc.peak_bf16_tflops
        print(f"shardbench {name}: mesh {arm['mesh']}, attention "
              f"{arm['attention']}, {arm['tflops']:.2f} TFLOP/s, MFU "
              f"{mfu:.4f}, spread {arm.get('tflops_spread', arm.get('note'))}"
              f", {arm['tokens_per_s']:.1f} tokens/s, flops_scope "
              f"{arm['flops_scope']}, points {arm['points']} ({smi_line})")
        check(0 < mfu <= 1.0, f"shardbench arm {name} MFU {mfu} outside "
                              f"(0, 1]")
    # every arm whose attention the crossover selector puts on the
    # kernels launches K1, K2 and K3 once a step it ran (warm-up pair
    # included); long_context (s8192, d_head 256) must be one of them
    ran, on_flash = 0, []
    for arm in shardbench.plan(doc["devices"], False):
        want = burnin.select_attention(arm.cfg, "cuda")
        check(doc["arms"][arm.name]["attention"] == want,
              f"shardbench arm {arm.name} ran "
              f"{doc['arms'][arm.name]['attention']}, the selector picks "
              f"{want}")
        if want == "flash":
            on_flash.append(arm.name)
            ran += 4 * arm.steps * (arm.reps + 1)
    check("long_context" in on_flash,
          "long_context arm not on the flash kernels")
    print(f"shardbench: {wall:.1f} s; launches K1 {launches[0]}, K2 "
          f"{launches[1]}, K3 {launches[2]} ({ran} steps run by the arms on "
          f"the kernels: {', '.join(on_flash)})")
    check(launches == [ran] * 3,
          f"shardbench launches K1/K2/K3 {launches}, expected {ran} each")
    roof = doc["collectives"]
    check("error" not in roof, f"shardbench collectives: {roof}")
    if roof["devices"] == 1:
        print("shardbench collectives: one rank: no link measured")
    else:
        print(f"shardbench collectives: all_reduce "
              f"{roof['all_reduce']['busbw_gib_s']} GiB/s, all_gather "
              f"{roof['all_gather']['busbw_gib_s']} GiB/s busbw over "
              f"{roof['devices']} ranks")
    return {"launches": launches}


def crossover_phase(torch, smi_line: str) -> dict:
    """The flash crossover (``kernels/crossover.run``): at its check seq,
    flash against ``xla`` logits and training gradients at both head
    widths; then the sweep, one row a point beside the card's name and
    power limit; the seq the rule picks on this run beside the constant
    in the code. Fails if flash loses to ``xla`` by more than the spread
    at the constant or above, or if a point launched K1, K2 or K3
    otherwise than once a flash call. Returns the launch counts by
    d_head."""
    from tpu_cluster_torch.kernels import crossover

    for fn in crossover.KERNELS:  # count the main path's run only
        fn.launches = 0
    t0 = time.perf_counter()
    result = crossover.run(torch.device("cuda"), smi_line,
                           say=lambda line: print(f"crossover: {line}"))
    wall = time.perf_counter() - t0
    total = [fn.launches for fn in crossover.KERNELS]
    by_head = result["launches"]
    print(f"crossover: {len(result['rows']) + len(result['arms'])} points "
          f"in {wall:.1f} s; launches K1/K2/K3 {total}, by d_head "
          f"{by_head}")
    for c in result["checks"]:
        check(c["ok"], f"crossover check at {c['width']} width failed: {c}")
    check(not result["against"],
          "flash loses to xla by more than the spread at or above "
          "FLASH_CROSSOVER_SEQ: " + "; ".join(
              crossover.format_row(r) for r in result["against"]))
    check(result["launches_ok"], "a crossover point launched K1/K2/K3 "
                                 "otherwise than once a flash call")
    check(total == [sum(n) for n in zip(*by_head.values())]
          and sorted(by_head) == [128, 256],
          f"crossover launches K1/K2/K3 {total} outside its points "
          f"{by_head}")
    return by_head


def host_phase(torch) -> None:
    """Discovery of the machine's card nodes, the node labels of its host
    layout (computed and from the labeler's CLI), and the rendered
    one-card Jobs: device-query's and vector-add's container command and
    args run here, on the card, and must exit 0 with ``ok``."""
    import tempfile

    from tpu_cluster_torch import topology
    from tpu_cluster_torch.discovery import devices, labels
    from tpu_cluster_torch.render import jobs
    from tpu_cluster_torch.spec import GpuSpec

    found = devices.discover()
    count = torch.cuda.device_count()
    print(f"host: discovered {len(found)} card node(s) "
          f"{[d.path for d in found]}; torch sees {count} card(s)")
    check(len(found) >= count, "fewer card nodes than cards torch sees")
    name = torch.cuda.get_device_name(0)
    card = topology.from_device_name(name)
    host = next((h for h in topology.HOST_TYPES.values()
                 if h.card is card and h.cards_per_host == count), None)
    check(host is not None, f"no host layout of {count} {name!r}")
    got = labels.compute_labels(host.name, found, "chip-smoke")
    print(f"host: labels of {host.name}: {json.dumps(got, sort_keys=True)}")
    check(got[labels.PRESENT] == "true"
          and got[labels.COUNT] == str(len(found))
          and got[labels.PRODUCT] == name.replace(" ", "-"),
          f"labels disagree with the card: {got}")
    cli = subprocess.run(
        [sys.executable, "-m", "tpu_cluster_torch.discovery.labeler",
         f"--accelerator={host.name}", "--oneshot", "--print",
         "--conditions"], capture_output=True, text=True, timeout=120,
        env={**os.environ, "NODE_NAME": "chip-smoke"})
    check(cli.returncode == 0, f"labeler: {cli.stderr}")
    record = json.loads(cli.stdout)
    # /dev-based discovery may count more nodes than the container's cards
    # (a node of another card's minor number beside nvidia0): the condition
    # then reads False on a healthy node, and is printed, not held
    print(f"host: labeler --oneshot --print --conditions: condition "
          f"{record['condition']['type']}={record['condition']['status']} "
          f"({record['condition']['message']}) with {len(found)} card "
          f"node(s) against {count} card(s) torch sees")
    check(record["labels"] == got, f"labeler's labels {record['labels']}")

    objs = {o["metadata"]["name"]: o for o in jobs.render_validation_jobs(
        GpuSpec(accelerator=host.name).validate())}
    print(f"host: rendered Jobs for {host.name}: {list(objs)}")
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "TPU_METRICS_FILE": os.path.join(tmp, "j.prom")}
        for job in ("gpu-device-query", "gpu-vector-add"):
            container = objs[job]["spec"]["template"]["spec"]["containers"][0]
            argv = container["command"] + container["args"]
            cards = container["resources"]["limits"]["nvidia.com/gpu"]
            t0 = time.perf_counter()
            proc = subprocess.run(argv, capture_output=True, text=True,
                                  timeout=600, env=env)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"{job} ({' '.join(argv)}) exited {proc.returncode}: "
                  f"{proc.stderr[-2000:]}")
            doc = json.loads(proc.stdout)
            print(f"host: {job} requests nvidia.com/gpu {cards}: "
                  f"{' '.join(argv)}: rc 0, ok {doc['ok']}, {wall:.1f} s")
            check(doc["ok"] is True, f"{job}: {doc}")


def profile(torch, label: str, fn, top: int = 10) -> list:
    """Device time by kernel over one call of ``fn`` (after a warm call):
    the ``top`` largest, then the rest summed. Returns every kernel's
    name."""
    from torch.profiler import ProfilerActivity, profile as trace

    fn()  # warm
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e) -> float:
        # the attribute's name changed across torch releases
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(device_us(e) for e in rows) / 1e3
    print(f"profile: {label} {wall_ms:.1f} ms wall, {total:.1f} ms device "
          f"time by kernel:")
    rows.sort(key=lambda e: -device_us(e))
    for e in rows[:top]:
        ms = device_us(e) / 1e3
        print(f"  {ms:8.2f} ms  {100 * ms / max(total, 1e-9):5.1f}%  "
              f"x{e.count}  {e.key[:90]}")
    rest = sum(device_us(e) for e in rows[top:]) / 1e3
    print(f"  {rest:8.2f} ms  {100 * rest / max(total, 1e-9):5.1f}%  "
          f"x{sum(e.count for e in rows[top:])}  the other "
          f"{len(rows) - len(rows[:top])} kernels")
    return [e.key for e in rows]


def profile_phase(torch, served: dict, trained: dict) -> None:
    """Device time by kernel over one decode iteration at the serving
    shape (four full slots) and over one training step; neither may run
    an f32 GEMM."""
    import numpy as np

    from tpu_cluster_torch.workloads import burnin

    cfg = served["engine"].cfg
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, cfg.vocab, (cfg.slots, cfg.seq)).astype(np.int32)
    pos = np.full((cfg.slots,), cfg.seq - 1, np.int32)
    runs = (("one decode iteration", 10,
             lambda: served["decode"](served["params"], tokens, pos)),
            ("one training step", 16, lambda: burnin.train_step(
                trained["params"], trained["batch"], trained["cfg"])))
    for label, top, fn in runs:
        names = profile(torch, label, fn, top=top)
        f32 = [k for k in names if any(f in k for f in F32_GEMMS)]
        check(not f32, f"{label} still runs f32 GEMMs: {f32}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    # the port must sit beside this script; nothing is printed without it
    import tpu_cluster_torch.workloads.serving  # noqa: F401
    name, acc, smi_line = device_phase(torch)
    build_phase()
    forward = flash_phase(torch, acc)
    backward = backward_phase(torch, acc)
    head_phase(torch)
    served = serving_phase(torch)
    trained = training_phase(torch)
    sharded = sharded_phase(torch, trained)
    timed = timed_phase(torch, acc, trained)
    validate_phase(torch)
    bench = shardbench_phase(torch, acc, smi_line)
    profile_phase(torch, served, trained)
    serving_launches, training_launches = (served["launches"],
                                           trained["launches"])
    del served, trained  # the sweep's xla points need the memory
    gc.collect()
    torch.cuda.empty_cache()
    cross = crossover_phase(torch, smi_line)
    host_phase(torch)
    # the records at d_head 256; those at 128 beside them
    k1 = forward[256]
    k1["training_shape"] = backward[256]["k1_training"]
    k1["head_dim_128"] = {**forward[128],
                          "training_shape": backward[128]["k1_training"]}
    k2, k3 = (dict(backward[256][n], head_dim_128=backward[128][n])
              for n in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"))
    k1["launches_by_path"] = {"serving": serving_launches}
    for i, record in enumerate((k1, k2, k3)):
        by_path = record.setdefault("launches_by_path", {})
        by_path["training"] = training_launches[i]
        by_path["sharded"] = sharded["launches"][i]
        by_path["timed_steps"] = timed["launches"][i]
        by_path["shardbench"] = bench["launches"][i]
        by_path["crossover"] = cross[256][i]
        record["launches"] = sum(by_path.values())
        # d_head 128 runs on the main paths only in the crossover
        narrow = record["head_dim_128"]
        narrow["launches_by_path"] = {"crossover": cross[128][i]}
        narrow["launches"] = cross[128][i]
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as err:
        print(f"chip_smoke: FAIL: {err}", file=sys.stderr)
        sys.exit(1)
