#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``tpu_cluster_torch``) on one
NVIDIA card. Run from the repository root: ``python3 chip_smoke.py``.

It drives the port's main paths with the burn-in transformer at GPT-J
block width (d4096, f16384, h16, vocab 8192), seq 8192, random weights
from seed 0 — the serving engine answering HTTP requests with 4 slots,
a second engine's replicas scaled by the fleet controllers on its duty
gauge,
``burnin.run`` training at batch 1, the sharded step at mesh (1, 1), and
``burnin.timed_steps`` timing that training — then the validation Job's
entry point, the sharded bench arms (``shardbench``), the flash crossover
sweep at both head widths, the host side (discovery, labels, the
rendered validation Jobs, the apply path and its traces), the SLOs over
the card's traces and the contract tools, and holds every kernel on
those paths against its plain PyTorch version on the card.
Phases, each fatal when it fails:

1. device: name, and name and power limit as nvidia-smi reports them;
   the card's catalogue entry (``tpu_cluster_torch/topology.py``), whose
   data-sheet peaks every bound and MFU below divides by;
2. build: every kernel from ``tpu_cluster_torch/csrc`` with nvcc, one
   process per source, all started together; ptxas's registers and
   spills (none allowed) and each launch's shared memory; the machine
   code of every instance of K1, K2 and K3 must hold wgmma (``HGMMA``)
   and TMA load (``UTMALDG``) instructions, that of the decode
   attention's split pass cp.async (``LDGSTS``);
3. kernels: K1 (forward) against its plain version at the stated shapes
   and tolerances, and its time at the serving shape of each head width
   (256 and 128) beside its bound, the plain version's time and one
   PyTorch library call's time;
4. backward kernels: K1's lse, K2 (dK, dV) and K3 (dQ) against their
   plain versions at the stated shapes and tolerances, and their times at
   the training shape of each head width beside their bounds, the plain
   versions' times and one PyTorch library call's time;
   The windowed kernels: K1 (with lse), K2 and K3 with the sparse
   training cell's window (1024) at its attention shape (B2 H32 S8192
   D128) against their plain versions with the same tolerances; with a
   window as long as the sequence equal to the causal kernels bit for
   bit; each one's time, windowed and causal, beside its bound at the
   work of the pairs its mask admits; then one ``burnin.train_step`` of
   the sparse model at Mellum2's widths (b1, s8192), whose loss must be
   finite, which must drop no routed pair, and whose K1, K2 and K3 must
   each launch once a layer;
   The decode attention (``kernels/decode_attention.py``): the kernel
   against its plain version at both serving cells' caches and lengths
   (4 slots, H32 D128, seq 8192; 8 slots, H16 D256, seq 2048), and its
   time there beside its byte bound, the plain version's time and SDPA's;
   The LM head: its tensor-core route (``burnin.lm_head``, a bf16
   cuBLAS product with f32 output, and split-cotangent gradients) against
   the f32 product of the up-cast operands at the training shape, within
   the stated bounds; its kernels by name (a bf16 tensor-core GEMM, no
   f32 GEMM);
5. serving: ``ServingServer`` answers concurrent ``POST /v1/generate``
   requests; the decode-attention kernel must launch once an engine
   iteration and K1 never (the decode attends each slot's cached keys);
   the metrics scrape must agree with the engine; one
   request's logits are recomputed with the plain attention path and
   compared with the kernel path;
   fleet: the fleet controllers on the card's own Node (discovery's
   labels, ``GpuReady``, the card count as capacity) in an in-process
   fake apiserver (``tests/fake_apiserver.py``, loaded by path):
   watch-driven admission over informers, a fresh serving engine behind
   ``ServingServer`` scraped every 0.5 s, and the autoscaler (1 to 2
   replicas, duty 50%/10% over the engine's own 5 s window, no
   cooldown). Idle, ``serving-0``'s gang is admitted on card 0 and the
   reservation table seats exactly ``[0]``; four closed-loop clients
   (one a slot) for about 8 s must scale out on duty alone, the new
   gang must queue ("waiting for 1 x 1-card host(s) ...") and no further
   scale-out may follow, and the decode attention must launch once an
   engine iteration and K1 never;
   idle again, a scale-in must delete ``serving-1`` whole. The scraper
   also reads the controllers' own registry (a second target,
   ``tpuctl``, served by ``MetricsServer``): under load, once a scrape
   after the scale-out has landed, ``metricsdb.render_dash`` over 5 s
   must show both targets up, a request rate and a p99 on the
   ``tpuctl`` row, and decoded tok/s above 0 with ``replicas 2`` (the
   engine's own decoded count over the window is printed beside it);
   after the scale-in, ``replicas 1``; ``dash --replay`` of the TSDB's
   dump (PyYAML blocked) must equal the in-process frame byte for byte,
   and ``live_slo_report`` over the TSDB must be ok with
   ``apply-availability`` samples. Then a maintenance wave over the Node (cordoned, drained with the Node in the
   table's cordon list, upgraded, done; its five Events; ``serving-0``
   drained and re-admitted; the target stack version on the Node), and
   ``python -m tpu_cluster_torch queue --json`` with PyYAML blocked must
   list ``serving/0`` admitted; the phase's spans are kept as its trace;
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
12. bench: ``python -m tpu_cluster_torch.bench`` in a process of its
   own on the card: its last line (printed, with its seconds) must be at
   most 1900 bytes, read platform ``cuda``, a headline rate above 0, an
   MFU of at most 1, all four train-step shapes with a rate, an MFU of at
   most 1 and no error (each on the ``xla`` path: s512 is below
   ``FLASH_CROSSOVER_SEQ``, so no flash kernel runs), ``validate`` ok,
   both serving arms with every request served (none past its deadline,
   none rejected), and the metrics round trip ok: the native exporter
   relayed the runtime metrics, the HBM limit among them, and its census
   counted as many cards as it expected, at least one (the relayed
   gauges, the census, the HBM limit and the duty are printed). Before
   it, both native binaries the bench entries drive
   (``tpu-metrics-exporter``, ``tpu-operator``) are built from
   ``native/`` with the host's C++ compiler
   (``tpu_cluster_torch/native_build.py``); the ``native:`` line gives
   each one's path, its build seconds (or ``reused``) and the compiler's
   version, and a failed build fails the phase. Then ``python -m
   tpu_cluster_torch.bench_rollout --check`` (its serving column on the
   card) must exit 0 with the native operator's columns (``drift_watch``,
   ``drift_poll``, ``operator_fleet``) present and free of errors; its
   request ratio, speedup, SSA and fleet columns, serving tokens ratio,
   the drift arms' repair times and the operator fleet's columns are
   printed;
13. crossover (``tpu_cluster_torch/kernels/crossover.py``): at both head
   widths, flash against ``xla`` logits and training gradients at one
   seq; then the sweep of seq 256 to 8192 on the serving and training
   paths, ``xla`` and flash in turns, one row a point beside the card's
   name and power limit; the seq the rule picks on this run beside
   ``FLASH_CROSSOVER_SEQ``; beside the grid, the training shape of
   ``shardbench``'s dp and mp arms (s512 b8 at d_head 256). Fails if
   flash loses to ``xla`` by more than the spread at the constant or
   above, or if a point launched K1, K2, K3 or the decode attention
   otherwise than once a flash call on its path (the serving path's
   flash is the decode attention over the cache, its ``xla`` the plain
   version);
14. host: the machine's cards (the ``/dev/nvidia*`` nodes whose minor
   numbers NVML reports), as many as torch sees, and the node labels of
   the card's host layout; then the GPU stack rendered for that layout
   (operand rollout groups, operator install, validation Jobs), which
   must lint with no error; node prep must make the NVIDIA container
   runtime containerd's default; the ``gpu-driver-prep`` scripts and the
   ``gpu-feature-discovery`` command run here, outside their containers,
   and must exit 0, the latter with the computed labels and ``GpuReady``
   True; and the validation Jobs' device-query and vector-add
   containers' command and args run here on the card and must exit 0
   with ``ok``. Then the apply path: on an in-process fake apiserver
   (``tests/fake_apiserver.py``, loaded by path), the port's
   ``kubeapply.Client`` with telemetry and ``lint_mode="error"`` applies
   that stack (operand groups with ``wait=True``, the operator install,
   the Jobs): every object must be stored, no workload of a group may be
   created before every workload of the group before it was read Ready
   (the server's request log), the trace must hold one ``rollout`` span a
   bundle with a ``group-N`` span a group and its ``apply`` and
   ``ready-wait`` phases, and no request may have been retried;
   ``delete_groups`` must leave none of the objects. ``python -m
   tpu_cluster_torch apply --apiserver URL --wait``, with PyYAML made
   unimportable, must exit 0 with ``apply: converged`` and a trace;
   ``trace merge`` of that trace and the fake's ``/__fake_trace`` must
   carry the CLI's trace id, ``trace validate`` of the merge and ``top``
   of the CLI's trace must exit 0, ``top`` listing the phases ``apply``,
   ``crd-establish`` and ``ready-wait``. And
   ``verify``: the labels, conditions, allocatable, device-query and
   vector-add checks must pass on a runner that answers ``kubectl`` from
   this phase's own output (feature discovery's record, the two Jobs'
   exit codes and logs), and ``conditions`` must fail when that record's
   ``GpuReady`` is False;
15. slo: ``slo check`` (PyYAML blocked) over the host phase's apply trace
   and the fleet phase's trace must exit 0 with samples for all three
   SLOs (``apply-availability``, ``watch-uptime``, ``admission-latency``);
   a copy of the apply trace with every non-watch request answered 503
   must exit 1 naming ``apply-availability`` and its window pair;
16. contracts: ``conlint`` and ``pinlint --strict`` on this checkout must
   exit 0, clean; their wall times are printed.

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
# The windowed kernels at the sparse training cell's attention (Mellum2:
# 32 query heads of 128, the keys and values repeated to them, batch 2,
# seq 8192) and its sliding window, checked with the tolerances above
# and timed beside the causal kernels at the same shape.
WINDOW_SHAPE = (2, 32, 8192, 128)  # B, H, S, D
WINDOW = 1024
# One step of the sparse model at Mellum2's widths (one period: three
# windowed layers and a full one) at batch 1, seq 8192: K1, K2 and K3
# launch once a layer.
SPARSE_BATCH, SPARSE_SEQ = 1, 8192
# The decode-attention kernel at the serving cells' caches, (slots, seq,
# H, D), and lengths like theirs: mpt7b8k-serve-offline's articles of
# ~5,400 tokens cut to 7551 plus abstracts; gptj6b-serve-poisson's code
# prompts of median 1500 cut to 1791 plus answers.
DECODE_SHAPES = (((4, 8192, 32, 128), (4200, 5400, 6600, 7800)),
                 ((8, 2048, 16, 256), (1000, 1200, 1400, 1500, 1500, 1600,
                                       1800, 2000)))
# Kernel against its plain version, bf16 outputs: f32 summation order and
# exp2 against exp may move the one rounding of an output by an ulp, at
# most 2^-7 of the largest magnitude.
DECODE_MAX_REL = 2 ** -7
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


def queued_ms(torch, fn, warmup: int, reps: int) -> float:
    """Median milliseconds of ``fn``'s device work between CUDA events,
    after warm-up, with the host ahead of the card: each timed call is
    queued behind a ~5 ms sleep kernel, so the events bracket the
    launches back to back and not the host's time to launch them (a call
    whose kernels take less time than their launches would otherwise
    time its host code)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)  # cycles
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
    """Build every kernel; fail on a ptxas spill in any instance, unless
    every flash instance's machine code holds wgmma (``HGMMA``) and TMA
    loads (``UTMALDG``), and unless every decode-attention split-pass
    instance's holds cp.async (``LDGSTS``). Prints each instance's
    registers and the dynamic shared memory its launch asks for."""
    import ctypes

    from tpu_cluster_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {len(_build.SOURCES)} kernel source(s) ready in "
          f"{time.perf_counter() - t0:.1f} s")
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
        flash = name in _build.FLASH_SOURCES
        smem_fn = lib.flash_attn_smem_bytes if flash \
            else lib.decode_attn_smem_bytes
        smem = {d: smem_fn(d) for d in (128, 256)}
        print(f"  {name}: dynamic shared memory a launch asks for: "
              + ", ".join(f"D={d} {n} bytes" for d, n in smem.items()))
        ops = ("HGMMA", "UTMALDG") if flash else ("LDGSTS",)
        stem = f"{name}_kernel" if flash else "decode_attn_split_kernel"
        counts = sass_counts(str(_build.library_path(name)), ops)
        kernels = {k: v for k, v in counts.items() if stem in k}
        for kernel, n in kernels.items():
            # the mangled name holds the instance:
            # ...kernelILi256ELi64ELb0E... (Lb: the window flag)
            args = re.findall(r"L[ib](\d+)E",
                              kernel.split("_kernel", 1)[1])
            print(f"  {stem}<{', '.join(args)}> SASS: "
                  + ", ".join(f"{op} x{n[op]}" for op in ops))
        # flash: D = 128 and 256, causal and windowed; decode: D = 128, 256
        check(len(kernels) == (4 if flash else 2)
              and all(n[op] > 0 for n in kernels.values() for op in ops),
              f"{name} instances without {'/'.join(ops)}: {kernels}")


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


def admitted_pairs(seq: int, window: int) -> int:
    """(query, key) pairs a head's mask admits: causal, or within
    ``window`` keys back (the query's own included)."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def window_phase(torch, acc) -> dict:
    """K1 (with lse), K2 and K3 with ``WINDOW`` at ``WINDOW_SHAPE`` against
    their plain versions; a window as long as the sequence against the
    causal kernels, bit for bit; each kernel's time, windowed and causal,
    with TFLOP/s and bound at the work of the pairs each mask admits;
    then one step of the sparse model at Mellum2's widths, whose K1, K2
    and K3 must launch once a layer. Returns the records by kernel and
    that step's launch counts."""
    from tpu_cluster_torch.kernels import flash_attention as fa
    from tpu_cluster_torch.workloads import burnin, sparse

    b, h, s, d = WINDOW_SHAPE
    tag = f"B{b} H{h} S{s} D{d} window {WINDOW}"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5

    def calls(window):
        o, lse = fa.flash_attention_with_lse(q, k, v, scale, window)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        inputs = (q, k, v, do, lse, di)
        return {"flash_attn_fwd": lambda: fa.flash_attention_with_lse(
                    q, k, v, scale, window),
                "flash_attn_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
                    *inputs, scale, window),
                "flash_attn_bwd_dq": lambda: fa.flash_attention_bwd_dq(
                    *inputs, scale, window)}, (o, lse), inputs

    windowed, (o, lse), inputs = calls(WINDOW)
    dk, dv = windowed["flash_attn_bwd_dkv"]()
    dq = windowed["flash_attn_bwd_dq"]()
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(x).all()) for x in (o, lse, dq, dk, dv)),
          f"windowed kernel output not finite at {tag}")
    ref_o, ref_lse = by_heads(
        torch, lambda *a: fa.flash_attention_reference(*a, True, WINDOW),
        (q, k, v), scale)
    err = (o.float() - ref_o.float()).abs()
    o_max, o_mean = err.max().item(), err.mean().item()
    lse_err = (lse - ref_lse).abs().max().item()
    print(f"flash_attn_fwd {tag}: o max_abs_err {o_max:.3e} (tol "
          f"{KERNEL_MAX_ABS}), mean_abs_err {o_mean:.3e} (tol "
          f"{KERNEL_MEAN_ABS}); lse max_abs_err {lse_err:.3e} (tol "
          f"{LSE_ATOL})")
    check(o_max <= KERNEL_MAX_ABS and o_mean <= KERNEL_MEAN_ABS
          and lse_err <= LSE_ATOL,
          f"windowed K1 disagrees with its plain version at {tag}")
    del ref_o, ref_lse, err
    errs = {"flash_attn_fwd": o_max}
    ref_dk, ref_dv = by_heads(
        torch, lambda *a: fa.flash_attention_bwd_dkv_reference(*a, WINDOW),
        inputs, scale)
    ref_dq = by_heads(
        torch, lambda *a: fa.flash_attention_bwd_dq_reference(*a, WINDOW),
        inputs, scale)
    for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                            ("dv", dv, ref_dv)):
        errs[name], max_rel, mean_rel = rel_errors(got, want)
        print(f"flash_attn_bwd {name} {tag}: max_abs/max|plain| "
              f"{max_rel:.3e} (tol {BWD_MAX_REL}), mean_abs/mean|plain| "
              f"{mean_rel:.3e} (tol {BWD_MEAN_REL})")
        check(max_rel <= BWD_MAX_REL and mean_rel <= BWD_MEAN_REL,
              f"windowed {name} disagrees with its plain version at {tag}")
    errs["flash_attn_bwd_dkv"] = max(errs["dk"], errs["dv"])
    errs["flash_attn_bwd_dq"] = errs["dq"]
    del ref_dk, ref_dv, ref_dq, dq, dk, dv
    torch.cuda.empty_cache()

    def outs(fn):
        got = fn()
        return got if isinstance(got, tuple) else (got,)

    causal, _, _ = calls(0)
    whole, _, _ = calls(s)
    for name in causal:
        same = all(torch.equal(x, y) for x, y in
                   zip(outs(causal[name]), outs(whole[name])))
        print(f"{name}: window {s} equals causal bit for bit: {same}")
        check(same, f"{name} with window {s} differs from causal")
    del whole

    tensor_bytes = b * s * h * d * 2.0
    row_bytes = b * h * s * 4.0
    # products and [B, S, H, D] tensors moved, and f32 rows, as the
    # backward phase counts them
    work = {"flash_attn_fwd": (2, 4, 1), "flash_attn_bwd_dkv": (4, 6, 2),
            "flash_attn_bwd_dq": (3, 5, 2)}
    records = {}
    for name, (n_products, n_tensors, n_rows) in work.items():
        records[name] = {"shape": [b, h, s, d], "window": WINDOW,
                         "max_abs_err": errs[name]}
        for label, window, table in (("window", WINDOW, windowed),
                                     ("causal", 0, causal)):
            flops = n_products * 2.0 * b * h * d * admitted_pairs(s, window)
            ms = cuda_ms(torch, table[name], warmup=3, reps=20)
            flop_ms = flops / (acc.peak_bf16_tflops * 1e12) * 1e3
            byte_ms = (n_tensors * tensor_bytes + n_rows * row_bytes) \
                / acc.hbm_bytes_per_s * 1e3
            records[name][label] = {
                "ms": ms, "tflops": flops / ms / 1e9,
                "bound_ms": max(flop_ms, byte_ms),
                "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}
            print(f"{name} B{b} H{h} S{s} D{d} {label}: kernel {ms:.3f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s at admitted pairs), "
                  f"bound {records[name][label]['bound_ms']:.3f} ms "
                  f"({records[name][label]['bound_by']})")
    del q, k, v, do, o, lse, inputs, windowed, causal
    torch.cuda.empty_cache()

    cfg = sparse.SparseConfig(vocab=98304, d_model=2304, n_heads=32,
                              n_kv_heads=4, d_head=128, n_experts=64,
                              top_k=8, d_expert=896, window=WINDOW)
    layers = len(cfg.layer_types)
    dev = torch.device("cuda")
    params = sparse.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(SEED + 5), dev)
    tokens = torch.randint(0, cfg.vocab, (SPARSE_BATCH, SPARSE_SEQ),
                           generator=gen, device=dev)
    batch = (tokens, torch.roll(tokens, -1, 1))
    counters = sparse.RouteCounters(layers, cfg.n_experts, dev)
    kernels = (fa.flash_attention, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    for fn in kernels:  # count the sparse step only
        fn.launches = 0
    _, loss = burnin.train_step(params, batch, cfg, counters=counters)
    torch.cuda.synchronize()
    launches = [fn.launches for fn in kernels]
    dropped = counters.read()["dropped_tokens"]
    print(f"sparse training: one step at Mellum2's widths ({layers} layers, "
          f"{cfg.layer_types}), b{SPARSE_BATCH} s{SPARSE_SEQ}: loss "
          f"{float(loss):.4f}, dropped pairs {dropped}; launches K1 "
          f"{launches[0]}, K2 {launches[1]}, K3 {launches[2]}")
    check(math.isfinite(float(loss)), f"sparse step loss {float(loss)}")
    check(dropped == 0, f"sparse step dropped {dropped} routed pairs")
    check(launches == [layers] * 3,
          f"sparse step launches K1/K2/K3 {launches}, expected {layers} "
          f"each (one a layer)")
    del params, tokens, batch, loss, counters
    torch.cuda.empty_cache()
    return {"records": records, "launches": launches}


def decode_phase(torch, acc) -> dict:
    """The decode-attention kernel at the serving cells' caches and
    lengths: against its plain version, then its time (CUDA events,
    median of 20, the host ahead: :func:`queued_ms`) beside its byte
    bound, the plain version's time and SDPA's over the same cache
    (``library_ms``, a yardstick the port never calls). Returns the
    record of each, by head width."""
    import torch.nn.functional as F

    from tpu_cluster_torch.kernels import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = {}
    for (slots, seq, heads, d), lens in DECODE_SHAPES:
        q = torch.randn((slots, heads, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((slots, seq, heads, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        longest, scale = max(lens), d ** -0.5
        kc, vc = k[:, :longest], v[:, :longest]
        out = da.decode_attention(q, k, v, lengths, scale, lens)
        ref = da.decode_attention_reference(q, kc, vc, lengths, scale)
        err = (out.float() - ref.float()).abs()
        max_rel = err.max().item() / ref.float().abs().max().item()
        shape = f"slots {slots} H{heads} D{d} seq {seq}, lengths {list(lens)}"
        print(f"decode_attn {shape}: max_abs_err / max|plain| {max_rel:.3e} "
              f"(tol {DECODE_MAX_REL})")
        check(max_rel <= DECODE_MAX_REL,
              f"decode kernel disagrees with its plain version at {shape}")
        ms = queued_ms(torch, lambda: da.decode_attention(
            q, k, v, lengths, scale, lens), warmup=3, reps=20)
        plain_ms = queued_ms(torch, lambda: da.decode_attention_reference(
            q, kc, vc, lengths, scale), warmup=1, reps=5)
        attend = (torch.arange(longest, device="cuda")[None, :]
                  < lengths[:, None].long())[:, None, None, :]
        qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        library_ms = queued_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attend, scale=scale), warmup=3, reps=20)
        # K and V of the attended rows read once, q read and o written
        nbytes = 2.0 * sum(lens) * heads * d * 2 + 2.0 * slots * heads * d * 2
        flops = 4.0 * sum(lens) * heads * d
        byte_ms = nbytes / acc.hbm_bytes_per_s * 1e3
        records[d] = record = {
            "name": "decode_attn", "route": "cuda",
            "source": "tpu_cluster_torch/csrc/decode_attn.cu",
            "replaces": "no TPU kernel (K1's place on the decode path)",
            "shape": [slots, seq, heads, d], "lengths": list(lens),
            "max_rel_err": max_rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": byte_ms, "bound_by": "bytes",
            "library_ms": library_ms, "gbps": nbytes / ms / 1e6,
            "flops": flops,
        }
        print(f"decode_attn {shape}: kernel {ms:.4f} ms "
              f"({record['gbps']:.0f} GB/s), bound {byte_ms:.4f} ms (bytes, "
              f"{nbytes / 1e6:.1f} MB; {flops / 1e6:.0f} MFLOP), plain "
              f"{plain_ms:.3f} ms, SDPA {library_ms:.4f} ms")
        del q, k, v, kc, vc, qt, kt, vt, out, ref, err
    torch.cuda.empty_cache()
    return records


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


def serving_config():
    """The served model: the burn-in transformer at GPT-J block width,
    seq 8192, 4 slots, bf16 (the engine's parameter type)."""
    from tpu_cluster_torch.workloads import burnin, serving

    std = burnin.standard_config()
    return serving.ServingConfig(
        vocab=std.vocab, d_model=std.d_model, d_ff=std.d_ff,
        n_heads=std.n_heads, seq=SERVING_SEQ, slots=SERVING_SLOTS,
        max_new_tokens=NEW_TOKENS, default_deadline_s=600.0)


def serving_phase(torch) -> dict:
    import numpy as np
    from dataclasses import replace

    from tpu_cluster_torch import telemetry
    from tpu_cluster_torch.kernels import decode_attention as da
    from tpu_cluster_torch.kernels import flash_attention as fa
    from tpu_cluster_torch.workloads import burnin, serving

    cfg = serving_config()
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
    # count the main path's run only
    da.decode_attention.launches = fa.flash_attention.launches = 0
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
        launches = da.decode_attention.launches
        k1 = fa.flash_attention.launches
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
    check(iterations > 0 and launches == iterations and k1 == 0,
          f"decode-attention launches {launches}, K1 {k1} vs engine "
          f"iterations {iterations} (one attention layer per decode, over "
          f"the cache)")
    print(f"serving: {len(prompts)} requests (prompts {list(PROMPT_LENS)} "
          f"tokens) all 200, {decoded} tokens in {iterations} iterations, "
          f"{wall:.3f} s wall: {wall / iterations * 1e3:.1f} ms/iteration, "
          f"{decoded / wall:.2f} decoded tokens/s; decode-attention "
          f"launches {launches}, K1 {k1}; peak device memory "
          f"{peak_gib:.1f} GiB")

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


# the fleet phase's autoscaling law: the engine's own duty window
# (serving.py's DutyCycleSampler) and a scale-out that one card cannot
# seat, so the second replica's gang must queue
FLEET_POLICY = dict(min_replicas=1, max_replicas=2, duty_high=50.0,
                    duty_low=10.0, window_s=5.0, cooldown_s=0.0)
FLEET_LOAD_S = 8.0
FLEET_PROMPT = 256
FLEET_PASS_S = 0.5
FLEET_TARGET_VERSION = "gpu-stack-2"


FLEET_DASH_WINDOW_S = 5.0
# the three SLOs the card's traces must carry samples for
SLO_NAMES = ("apply-availability", "watch-uptime", "admission-latency")


def _port_cli(*argv, timeout: float = 300):
    """``python -m tpu_cluster_torch ARGV`` from the repository root with
    PyYAML made unimportable, whether or not this machine has it: only
    the kubectl backend and ``render`` need it."""
    no_yaml = ("import runpy, sys; sys.modules['yaml'] = None; "
               "runpy.run_module('tpu_cluster_torch', run_name='__main__', "
               "alter_sys=True)")
    return subprocess.run([sys.executable, "-c", no_yaml, *map(str, argv)],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))


def _dash_rows(frame: str) -> dict:
    """A dash frame's target rows: job -> [UP, REQ/S, ERR/S, P99(MS)]."""
    lines = frame.split("\n")
    rows = {}
    for line in lines[2:]:
        fields = line.split()
        if len(fields) >= 5 and fields[1] in ("0", "1", "?"):
            rows[fields[0]] = fields[1:5]
    return rows


def _until(what: str, cond, timeout: float, step=None):
    """Run ``step`` (when given) and re-test ``cond`` until it holds;
    fails the run after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        if step is not None:
            step()
        value = cond()
        if value:
            return value
        check(time.monotonic() < deadline,
              f"fleet: {what} did not happen within {timeout:.0f} s")
        time.sleep(0.05)


def _load(url: str, prompt, stop: threading.Event, done: list) -> None:
    """One closed-loop client: a request, its reply, the next."""
    while not stop.is_set():
        replies = [None]
        _post(url, prompt, replies, 0)
        done.append(replies[0][0] if replies[0] else None)


def fleet_phase(torch, trace_dir=None) -> dict:
    """The fleet controllers on the card's own Node and its serving
    engine's duty gauge: admission (watch-driven) seats the autoscaler's
    replica gangs, the autoscaler scales out on the card's duty under
    load and back in when idle, the dash reads the engine's and the
    controllers' scraped series under load and after the scale-in (and
    replays from a dump), the live SLO holds over them, a maintenance
    wave drains and re-admits the card's gang, and the queue CLI reads it
    without PyYAML. The phase's trace goes to ``trace_dir`` when given."""
    import tempfile

    import numpy as np

    from tpu_cluster_torch import (admission, autoscale, events, kubeapply,
                                   maintenance, metricsdb, telemetry)
    from tpu_cluster_torch.discovery import labeler, labels
    from tpu_cluster_torch.kernels import decode_attention as da
    from tpu_cluster_torch.kernels import flash_attention as fa
    from tpu_cluster_torch.slo import format_report as slo_format
    from tpu_cluster_torch.spec import default_spec
    from tpu_cluster_torch.workloads import runtime_metrics, serving

    t_phase = time.perf_counter()
    found, host = card_host(torch)
    spec = default_spec()
    ns, resource = spec.gpu.namespace, spec.gpu.resource_name
    fake = _load_fake_apiserver()
    node = card_node(labels.compute_labels(host.name, found, "chip-smoke"),
                     labeler.gpu_ready_condition(host.name, len(found)),
                     resource, len(found))
    jobs_path = f"/apis/batch/v1/namespaces/{ns}/jobs"
    table_path = (f"/api/v1/namespaces/{ns}/configmaps/"
                  f"{admission.RESERVATION_CONFIGMAP}")

    engine = serving.InferenceEngine(serving_config(),
                                     telemetry=telemetry.Telemetry())
    t0 = time.perf_counter()
    engine._ensure_model()
    torch.cuda.synchronize()
    print(f"fleet: a fresh engine for the replica, model built in "
          f"{time.perf_counter() - t0:.1f} s")
    server = serving.ServingServer(engine)

    tel = telemetry.Telemetry(retain_spans=True)
    stop = threading.Event()
    with fake.FakeApiServer(auto_ready=True) as api:
        client = kubeapply.Client(api.url, telemetry=tel)
        client.apply(node)
        host_view = admission.host_capacity(api.get("/api/v1/nodes/"
                                                    "chip-smoke"))
        print(f"fleet: Node chip-smoke: {host_view.accelerator}, "
              f"{host_view.cards} card(s), ready {host_view.ready}")
        check(host_view.accelerator == host.name
              and host_view.cards == len(found) and host_view.ready,
              f"the card's Node reads as {host_view}")
        adm = admission.AdmissionController(
            client, ns, telemetry=tel,
            events=events.EventRecorder(client, component="gpu-admission",
                                        telemetry=tel))
        # one-second watch windows: stopping an informer waits for its
        # window to end
        informers = adm.build_informers(window_s=1).start()
        check(informers.wait_synced(30), "admission informers never synced")
        loop = threading.Thread(target=adm.run_watch, name="admission",
                                kwargs={"resync": FLEET_PASS_S,
                                        "stop": stop})
        loop.start()
        tsdb = metricsdb.TSDB()
        scraper = tel_server = None
        try:
            # count this phase's run only
            for fn in (fa.flash_attention, fa.flash_attention_bwd_dkv,
                       fa.flash_attention_bwd_dq, da.decode_attention):
                fn.launches = 0
            server.start()
            # the controllers' own registry (the client's request
            # families, the autoscaler's replicas) as a second target
            tel_server = metricsdb.MetricsServer(tel.metrics, 0).start()
            scraper = metricsdb.ScrapeManager(
                [metricsdb.Target("serving-0", server.metrics_url),
                 metricsdb.Target("tpuctl", tel_server.url)], tsdb,
                interval_s=FLEET_PASS_S, telemetry=tel).start()
            ctrl = autoscale.AutoscaleController(
                client, ns, job="serving", accelerator=host.name,
                policy=autoscale.AutoscalePolicy(**FLEET_POLICY),
                tsdb=tsdb, telemetry=tel,
                events=events.EventRecorder(client,
                                            component="gpu-autoscale",
                                            telemetry=tel))
            passes = []
            # (monotonic time, tokens the engine decoded), a pass each
            decoded = []

            def one_pass():
                passes.append(ctrl.step())
                decoded.append((time.monotonic(), engine.decoded_tokens))
                time.sleep(FLEET_PASS_S)
                return passes[-1]

            def replicas_scraped():
                reps = tsdb.latest(telemetry.AUTOSCALE_REPLICAS)
                return metricsdb.aggregate(reps, "max") if reps else None

            # 1. idle: serving-0 converges and admission seats its gang
            one_pass()
            seat = _until("the admission of serving/0",
                          lambda: adm.admitted_snapshot().get("serving/0"),
                          30, one_pass)
            table = admission.parse_table(json.loads(
                api.get(table_path)["data"][admission.RESERVATION_KEY]))
            alone = admission.check_allocation(table, "chip-smoke", [0])
            twice = admission.check_allocation(table, "chip-smoke", [0, 0])
            print(f"fleet: idle: {passes[-1].line()}; gang serving/0 "
                  f"admitted on {seat.hosts}; check_allocation [0] "
                  f"{alone}, [0, 0] {twice}")
            check(seat.hosts == (("chip-smoke", (0,)),),
                  f"serving/0 reserved {seat.hosts}")
            check(alone == (True, "serving/0"), f"[0]: {alone}")
            check(not twice[0] and "duplicate" in twice[1], f"[0, 0]: {twice}")

            # 2. load: as many closed-loop clients as the engine has slots
            rng = np.random.default_rng(SEED)
            prompt = rng.integers(0, engine.cfg.vocab, FLEET_PROMPT).tolist()
            done, load_stop = [], threading.Event()
            clients = [threading.Thread(target=_load,
                                        args=(server.url, prompt, load_stop,
                                              done))
                       for _ in range(engine.cfg.slots)]
            it0 = engine.iterations
            t_load = time.monotonic()
            for th in clients:
                th.start()
            up = None
            queues = []
            while time.monotonic() - t_load < FLEET_LOAD_S or up is None:
                check(time.monotonic() - t_load < 60,
                      "fleet: no scale-out within 60 s of load")
                res = one_pass()
                queues.append(res.view.queue_depth)
                if res.verdict == autoscale.VERDICT_UP:
                    check(up is None, f"a second scale-out: {res.line()}")
                    up, up_after = res, time.monotonic() - t_load
                elif up is not None:
                    check(res.verdict in (autoscale.VERDICT_BLOCKED,
                                          autoscale.VERDICT_HOLD),
                          f"after the scale-out: {res.line()}")
            # the dash under load, once a scrape after the scale-out
            # has landed
            _until("a scrape of replicas 2",
                   lambda: replicas_scraped() == 2, 10)
            frame = metricsdb.render_dash(tsdb, window_s=FLEET_DASH_WINDOW_S)
            now_tok = (time.monotonic(), engine.decoded_tokens)
            then = [d for d in decoded
                    if d[0] <= now_tok[0] - FLEET_DASH_WINDOW_S]
            then = then[-1] if then else decoded[0]
            engine_tok_s = (now_tok[1] - then[1]) / (now_tok[0] - then[0])
            print("fleet: dash under load:\n" + frame)
            print(f"fleet: the engine's own count: {now_tok[1] - then[1]:.0f}"
                  f" token(s) decoded in the last {now_tok[0] - then[0]:.1f}"
                  f" s, {engine_tok_s:.1f} tok/s (for the record)")
            rows = _dash_rows(frame)
            tok = re.search(r"serving \([^)]*\): tok/s ([0-9.]+)", frame)
            check(sorted(rows) == ["serving-0", "tpuctl"]
                  and all(r[0] == "1" for r in rows.values()),
                  f"dash rows under load: {rows}")
            check(float(rows["tpuctl"][1]) > 0 and rows["tpuctl"][3] != "-",
                  f"the tpuctl row {rows['tpuctl']}")
            check(tok is not None and float(tok.group(1)) > 0
                  and "| replicas 2" in frame,
                  "the serving panel under load")
            load_stop.set()
            for th in clients:
                th.join(timeout=120)
            load_s = time.monotonic() - t_load
            launches_load = da.decode_attention.launches
            k1_load = fa.flash_attention.launches
            iterations_load = engine.iterations - it0
            duty = up.view.duty_percent
            print(f"fleet: load: {up.line()}; duty read at the decision "
                  f"{duty:.1f}%, reaction_s {up.reaction_s} (overload seen "
                  f"-> decided), {up_after:.2f} s after the load began; "
                  f"queue depths seen "
                  f"{sorted(set(q for q in queues if q is not None))}")
            check(up.reason.startswith("duty"),
                  f"the scale-out's reason {up.reason!r}")
            check(up.applied == ["serving-1"], f"applied {up.applied}")
            series = tsdb.latest(runtime_metrics.DUTY_CYCLE_PERCENT,
                                 job="serving-0")
            check(len(series) == 1, f"duty series in the TSDB: {series}")
            queued = _until(
                "the arbitration of serving/1",
                lambda: adm.decisions_snapshot().get("serving/1"), 30)
            print(f"fleet: gang serving/1: {queued.status} ({queued.reason})")
            check(queued.status == admission.STATUS_QUEUED
                  and queued.reason.startswith(
                      f"waiting for 1 x {host.cards_per_host}-card host(s) "
                      f"for {host.name}"),
                  f"serving/1's decision {queued}")
            codes = sorted(set(done))
            print(f"fleet: {len(done)} request(s) in {load_s:.1f} s by "
                  f"{len(clients)} closed-loop client(s), HTTP {codes}; "
                  f"decode-attention launches {launches_load}, K1 "
                  f"{k1_load}, engine iterations {iterations_load}")
            check(codes == [200], f"HTTP codes {codes}")
            check(iterations_load > 0 and launches_load == iterations_load
                  and k1_load == 0,
                  f"decode-attention launches {launches_load}, K1 "
                  f"{k1_load} vs iterations {iterations_load} under load")

            # 3. idle again: the window drains, serving-1 goes whole
            down = _until(
                "the scale-in",
                lambda: passes[-1].verdict == autoscale.VERDICT_DOWN
                and passes[-1], 60, one_pass)
            print(f"fleet: idle again: {down.line()}")
            check(down.deleted == ["serving-1"], f"deleted {down.deleted}")
            _until("serving/1's release",
                   lambda: "serving/1" not in adm.decisions_snapshot(), 30)
            jobs = sorted(client.list_collection(jobs_path))
            check(jobs == ["serving-0"], f"Jobs after the scale-in: {jobs}")
            check("serving/0" in adm.admitted_snapshot(),
                  "serving/0 lost its seat in the scale-in")
            verdicts = [p.verdict for p in passes]
            print(f"fleet: autoscale: {len(passes)} pass(es) {verdicts}")
            check(verdicts.count(autoscale.VERDICT_UP) == 1
                  and verdicts.count(autoscale.VERDICT_DOWN) == 1,
                  f"verdicts {verdicts}")
            _until("a scrape of replicas 1",
                   lambda: replicas_scraped() == 1, 10)
            frame = metricsdb.render_dash(tsdb, window_s=FLEET_DASH_WINDOW_S)
            print("fleet: dash after the scale-in:\n" + frame)
            check("| replicas 1" in frame, "the serving panel after the "
                                           "scale-in")
        finally:
            if scraper is not None:
                scraper.stop()
            if tel_server is not None:
                tel_server.stop()
            server.stop()

        # the frame from a dump, through the CLI, and the live SLO
        with tempfile.TemporaryDirectory() as tmp:
            dump = os.path.join(tmp, "fleet-tsdb.json")
            with open(dump, "w", encoding="utf-8") as f:
                json.dump(tsdb.dump(), f)
            with open(dump, encoding="utf-8") as f:
                want = metricsdb.render_dash(metricsdb.TSDB.load(json.load(f)))
            t0 = time.perf_counter()
            proc = _port_cli("dash", "--replay", dump)
            wall = time.perf_counter() - t0
        check(proc.returncode == 0 and proc.stdout == want + "\n",
              f"dash --replay exited {proc.returncode}: {proc.stderr} "
              f"{proc.stdout!r} against {want!r}")
        print(f"fleet: python -m tpu_cluster_torch dash --replay DUMP with "
              f"PyYAML blocked: rc 0, equal to the in-process frame at the "
              f"dump's clock ({len(want.splitlines())} lines), {wall:.2f} s")
        live = metricsdb.live_slo_report(tsdb)
        avail = {v.slo.name: v for v in live.verdicts}["apply-availability"]
        print(f"fleet: live SLO over the fleet's TSDB: ok {live.ok}, "
              f"apply-availability {avail.total_samples} sample(s) (the "
              f"tpuctl target's {telemetry.REQUESTS_TOTAL})")
        check(live.ok and avail.total_samples > 0,
              "the live SLO over the fleet's TSDB:\n"
              + slo_format(live))
        launches = da.decode_attention.launches
        flash = (fa.flash_attention.launches,
                 fa.flash_attention_bwd_dkv.launches,
                 fa.flash_attention_bwd_dq.launches)
        print(f"fleet: decode-attention launches {launches} over the "
              f"engine's {engine.iterations} iterations; K1, K2, K3 "
              f"{flash}")
        check(launches == engine.iterations,
              f"decode-attention launches {launches} vs engine iterations "
              f"{engine.iterations} in the phase")
        check(flash == (0, 0, 0), f"K1, K2, K3 launched {flash} serving")

        # 4. a maintenance wave over the card's Node
        plan = maintenance.plan_from_cluster(client, FLEET_TARGET_VERSION)
        check([(g.name, g.hosts) for g in plan.groups]
              == [("g/0", ("chip-smoke",))], f"the wave plan {plan}")
        mctrl = maintenance.MaintenanceController(
            client, ns, plan=plan, telemetry=tel,
            events=events.EventRecorder(client, component="gpu-maintenance",
                                        telemetry=tel))
        phases, cordoned = [], []

        def wave_pass():
            res = mctrl.step()
            phases.extend(p for _g, p in res.transitions)
            if phases and phases[-1] == maintenance.PHASE_DRAINED \
                    and not cordoned:
                doc = api.get(table_path)["data"][admission.RESERVATION_KEY]
                cordoned.append(admission.parse_table(json.loads(doc))
                                .cordoned)
            time.sleep(0.1)
            return res

        _until("the wave", lambda: wave_pass().complete, 60)
        readmitted = _until("serving/0's re-admission",
                            lambda: adm.admitted_snapshot().get("serving/0"),
                            30)
        version = api.get("/api/v1/nodes/chip-smoke")["metadata"]["labels"] \
            .get(maintenance.VERSION_LABEL)
        stored = [api.get(p) for p in sorted(api.paths("/events/"))]
        wave = [e["reason"] for e in stored
                if e["involvedObject"]["name"]
                == maintenance.MAINTENANCE_CONFIGMAP]
        gang = [e["reason"] for e in stored
                if e["involvedObject"]["name"] == "serving-0"]
        print(f"fleet: maintenance: phases {phases}, cordoned in the table "
              f"while drained {cordoned}, wave events {wave}, serving-0's "
              f"events {gang}, stack-version {version}")
        check(phases == [maintenance.PHASE_CORDONED, maintenance.PHASE_DRAINED,
                         maintenance.PHASE_UPGRADED, maintenance.PHASE_DONE],
              f"phases {phases}")
        check(cordoned == [("chip-smoke",)], f"cordoned {cordoned}")
        check(sorted(wave) == sorted([
            maintenance.EVENT_CORDON_STARTED, maintenance.EVENT_GANG_DRAINED,
            maintenance.EVENT_UPGRADE_APPLIED, maintenance.EVENT_UNCORDONED,
            maintenance.EVENT_WAVE_COMPLETE]), f"wave events {wave}")
        check(gang == sorted(gang, key=[admission.EVENT_ADMITTED,
                                        admission.EVENT_DRAINED,
                                        admission.EVENT_READMITTED].index)
              and admission.EVENT_DRAINED in gang
              and admission.EVENT_READMITTED in gang,
              f"serving-0's events {gang}")
        check(readmitted.hosts == (("chip-smoke", (0,)),),
              f"serving/0 re-admitted on {readmitted.hosts}")
        check(version == FLEET_TARGET_VERSION, f"stack-version {version}")

        # 5. the queue CLI with PyYAML made unimportable
        proc = _port_cli("queue", "--apiserver", api.url, "--json",
                         timeout=120)
        check(proc.returncode == 0, f"queue --json exited "
                                    f"{proc.returncode}: {proc.stderr}")
        gangs = {g["name"]: g["status"]
                 for g in json.loads(proc.stdout)["gangs"]}
        print(f"fleet: python -m tpu_cluster_torch queue --apiserver URL "
              f"--json with PyYAML blocked: rc 0, gangs {gangs}")
        check(gangs == {"serving/0": admission.STATUS_ADMITTED},
              f"queue lists {gangs}")
        stop.set()
        loop.join(timeout=30)
        informers.stop()
        client.close()
    check(not loop.is_alive(), "the admission loop did not stop")
    if trace_dir is not None:
        path = os.path.join(trace_dir, "fleet-trace.json")
        tel.write_trace(path)
        with open(path, encoding="utf-8") as f:
            spans = sum(1 for e in json.load(f)["traceEvents"]
                        if e.get("ph") == "X")
        print(f"fleet: trace of {spans} span(s) written")
    wall = time.perf_counter() - t_phase
    print(f"fleet: phase wall {wall:.1f} s")
    return {"launches": launches, "wall_s": wall, "duty": duty,
            "reaction_s": up.reaction_s, "up_after_s": up_after,
            "passes": len(passes), "requests": len(done)}


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


# The bench entry's line must fit the last ~2000 bytes of output its
# readers keep (``tpu_cluster_torch/bench.py``'s TAIL_BUDGET).
BENCH_LINE_BYTES = 1900


def _entry(module: str, *argv, timeout: float):
    """``python -m MODULE ARGV`` from the repository root, on the card;
    returns the process and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.perf_counter() - t0


def bench_phase(smi_line: str) -> None:
    """The port's two measuring entries, each in a process of its own on
    the card: ``tpu_cluster_torch.bench`` (its line held to the contract
    of its readers; the full document read back from its sidecar for the
    spreads the line may shed) and ``tpu_cluster_torch.bench_rollout
    --check``."""
    from tpu_cluster_torch import bench
    from tpu_cluster_torch.workloads import burnin

    shapes = bench.train_shapes("cuda")
    check(all(cfg.attention == "xla" for _, cfg, _ in shapes),
          f"bench train shapes not all on xla: "
          f"{[(n, c.attention) for n, c, _ in shapes]}")
    print(f"bench: train shapes s{shapes[0][1].seq} on xla "
          f"(FLASH_CROSSOVER_SEQ {burnin.FLASH_CROSSOVER_SEQ}): no flash "
          f"kernel on this path")
    native_line(smi_line)
    proc, wall = _entry("tpu_cluster_torch.bench", timeout=900)
    check(proc.returncode == 0,
          f"bench exit {proc.returncode}: {proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    print(f"bench: {wall:.1f} s ({smi_line})")
    print(f"bench line: {line}")
    check(len(line.encode()) <= BENCH_LINE_BYTES,
          f"bench line {len(line.encode())} bytes > {BENCH_LINE_BYTES}")
    doc = json.loads(line)
    check(doc["platform"] == "cuda" and doc["value"] > 0,
          f"bench platform {doc['platform']} value {doc['value']}")
    check("mfu" in doc and doc["mfu"] <= 1.0,
          f"bench headline MFU {doc.get('mfu')} missing or above 1")
    train = doc.get("train_step") or {}
    check(set(train) == {"standard", "standard_bf16_params",
                         "standard_bf16", "wide"},
          f"bench train_step shapes {sorted(train)}")
    for name, entry in train.items():
        check("error" not in entry and entry.get("tflops", 0) > 0
              and entry.get("mfu", 2.0) <= 1.0,
              f"bench train_step {name}: {entry}")
    check(doc["validate"].get("ok") is True,
          f"bench validate: {doc['validate']}")
    serving = doc["serving"]
    for arm in ("continuous", "static"):
        got = serving.get(arm) or {}
        check(got.get("ok") == got.get("requests")
              and got.get("deadline") == 0 and got.get("rejected") == 0,
              f"bench serving {arm}: {serving}")
    check(doc["metrics_scrape"].get("ok") is True,
          f"bench metrics_scrape: {doc['metrics_scrape']}")
    with open(os.path.join(bench.REPO, doc["detail"]),
              encoding="utf-8") as f:
        full = json.load(f)
    scrape = full["metrics_scrape"]
    card = scrape["card"]
    print(f"bench metrics_scrape: ok, {len(scrape['gauges'])} gauges "
          f"through the native exporter {scrape['gauges']}; census "
          f"{card['chips_total']:g} of {card['chips_expected']:g} card(s) "
          f"(exporter flags {card['exporter_flags']}; census chip labels "
          f"{card['census_chips']}, relayed chip labels "
          f"{card['relay_chips']}); HBM limit {card['hbm_limit_bytes']} "
          f"bytes, used {scrape.get('hbm_used_bytes')} bytes from "
          f"{scrape['hbm_source']}; duty "
          f"{scrape.get('duty_cycle_percent')}%, tensorcore "
          f"{scrape.get('tensorcore_utilization_percent')}% ({smi_line})")
    spread = full.get("measure_tflops_spread", full.get("measure_note"))
    print(f"bench matmul: {full['value']} TFLOP/s bf16 (MFU {full['mfu']}), "
          f"spread {spread}, points {full['measure_points']}, excluded "
          f"warm-up pair "
          f"{full['measure_warmup_pair_s']} s ({smi_line})")
    for name, entry in full["train_step"].items():
        print(f"bench train_step {name}: {entry['config']}: "
              f"{entry['tflops']} TFLOP/s, MFU {entry['mfu']}, "
              f"{entry['tokens_per_s']} tokens/s, spread "
              f"{entry.get('tflops_spread', entry.get('note'))}, points "
              f"{entry['points']}")
    for arm in ("continuous", "static"):
        got = serving[arm]
        print(f"bench serving {arm}: {got['tokens_per_s']} tokens/s, p50 "
              f"{got['p50_ms']} ms, p99 {got['p99_ms']} ms, "
              f"{got['iterations']} iterations, occupancy "
              f"{got['occupancy']}")
    print(f"bench serving tokens_ratio {serving['tokens_ratio']}")

    proc, wall = _entry("tpu_cluster_torch.bench_rollout", "--check",
                        timeout=600)
    check(proc.returncode == 0,
          f"bench_rollout --check exit {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    roll = json.loads(proc.stdout.strip().splitlines()[-1])
    fleet = roll["fleet"]
    print(f"bench_rollout --check: rc 0, {wall:.1f} s; request_ratio "
          f"{roll['request_ratio']}, speedup {roll['speedup']}, ssa "
          f"{json.dumps(roll['ssa'])}, fleet "
          f"{json.dumps(fleet)}, serving tokens_ratio "
          f"{roll['serving']['tokens_ratio']}")
    for arm in ("continuous", "static"):
        got = roll["serving"][arm]
        print(f"bench_rollout serving {arm}: {got['tokens_per_s']} "
              f"tokens/s, p50 {got['p50_ms']} ms, p99 {got['p99_ms']} ms, "
              f"{got['iterations']} iterations")
    ready, opf = roll["readiness"], roll["operator_fleet"]
    for col in (ready.get("drift_watch"), ready.get("drift_poll"), opf):
        check(isinstance(col, dict) and "error" not in col,
              f"bench_rollout operator columns: drift_watch "
              f"{ready.get('drift_watch')}, drift_poll "
              f"{ready.get('drift_poll')}, operator_fleet {opf}")
    print(f"bench_rollout operator arms: drift_to_repaired_s watch "
          f"{ready['drift_watch']['drift_to_repaired_s']} s (interval "
          f"{ready['drift_watch']['interval_s']} s), poll "
          f"{ready['drift_poll']['drift_to_repaired_s']} s (interval "
          f"{ready['drift_poll']['interval_s']} s); operator_fleet "
          f"{opf['operands']} operands, {opf['nodes']} nodes: synced in "
          f"{opf['sync_s']} s, {opf['idle_requests']} idle requests over "
          f"{opf['idle_window_s']} s, repair {opf['drift_to_repaired_s']} s "
          f"in {opf['repair_requests']} requests, reconcile p99 "
          f"{opf['reconcile_p99_s']} s over {opf['reconcile_slices']} "
          f"slices ({smi_line})")


def native_line(smi_line: str) -> None:
    """Build the native binaries the bench entries drive, from
    ``native/`` with the host's C++ compiler, and print where each lies,
    its build seconds (or ``reused``) and the compiler's version; a
    failed build fails the phase."""
    from tpu_cluster_torch import native_build

    try:
        built = native_build.build()
        version = native_build.compiler_version()
    except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
        raise SmokeFailure(f"native build: {exc}") from None
    parts = []
    for target, seconds in built.items():
        path = os.path.relpath(native_build.binary_path(target),
                               native_build.REPO)
        when = "reused" if seconds is None else f"built in {seconds:.1f} s"
        parts.append(f"{target} {path} ({when})")
    print(f"native: {'; '.join(parts)}; {version} ({smi_line})")


def crossover_phase(torch, smi_line: str) -> dict:
    """The flash crossover (``kernels/crossover.run``): at its check seq,
    flash against ``xla`` logits and training gradients at both head
    widths; then the sweep, one row a point beside the card's name and
    power limit; the seq the rule picks on this run beside the constant
    in the code. Fails if flash loses to ``xla`` by more than the spread
    at the constant or above, or if a point launched K1, K2, K3 or the
    decode attention otherwise than once a flash call on its path.
    Returns the launch counts by d_head (K1, K2, K3, decode)."""
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
          f"in {wall:.1f} s; launches K1/K2/K3/decode {total}, by d_head "
          f"{by_head}")
    for c in result["checks"]:
        check(c["ok"], f"crossover check at {c['width']} width failed: {c}")
    check(not result["against"],
          "flash loses to xla by more than the spread at or above "
          "FLASH_CROSSOVER_SEQ: " + "; ".join(
              crossover.format_row(r) for r in result["against"]))
    check(result["launches_ok"], "a crossover point launched K1/K2/K3/decode "
                                 "otherwise than once a flash call")
    check(total == [sum(n) for n in zip(*by_head.values())]
          and sorted(by_head) == [128, 256],
          f"crossover launches K1/K2/K3/decode {total} outside its points "
          f"{by_head}")
    return by_head


def host_phase(torch, trace_dir=None) -> None:
    """Discovery of the machine's cards (the device nodes whose minor
    numbers NVML reports), the node labels of its host layout, then the
    GPU stack rendered for that layout: the operand rollout groups, the
    operator install and the validation Jobs must lint with no error; the
    ``gpu-driver-prep`` DaemonSet's shell scripts and the
    ``gpu-feature-discovery`` container's command run here and must exit
    0, the latter with the labels computed here and ``GpuReady`` True; and
    device-query's and vector-add's container command and args run on the
    card and must exit 0 with ``ok``. The apply CLI's trace goes to
    ``trace_dir`` when given."""
    import tempfile

    from tpu_cluster_torch import lint
    from tpu_cluster_torch.discovery import devices, labels
    from tpu_cluster_torch.render import (jobs, manifests, nodeprep,
                                          operator_bundle)
    from tpu_cluster_torch.spec import default_spec

    found, host = card_host(torch)
    count = len(found)
    name = torch.cuda.get_device_name(0)
    print(f"host: discovered {len(found)} card(s) {[d.path for d in found]}"
          f" (card nodes whose minor NVML reports; NVML minors "
          f"{devices.nvml_minors()}); torch sees {count} card(s)")
    got = labels.compute_labels(host.name, found, "chip-smoke")
    print(f"host: labels of {host.name}: {json.dumps(got, sort_keys=True)}")
    check(got[labels.PRESENT] == "true"
          and got[labels.COUNT] == str(count)
          and got[labels.PRODUCT] == name.replace(" ", "-"),
          f"labels disagree with the card: {got}")

    t0 = time.perf_counter()
    spec = default_spec()
    spec.gpu.accelerator = host.name
    spec.validate()
    bundles = {"operands": manifests.rollout_groups(spec),
               "operator": operator_bundle.operator_install_groups(spec),
               "jobs": [jobs.render_validation_jobs(spec.gpu)]}
    for what, groups in bundles.items():
        findings = lint.lint_groups(groups, spec=spec)
        errs = lint.errors(findings)
        names = [f"{o['kind']}/{o['metadata']['name']}"
                 for group in groups for o in group]
        print(f"host: {what} rendered for {host.name}: {len(groups)} "
              f"group(s), {len(names)} object(s) {names}; lint "
              f"{len(errs)} error(s), {len(findings) - len(errs)} warning(s)")
        check(not errs, f"the {what} bundle fails lint: "
                        + "; ".join(f.line() for f in errs))

    # The scripts below run here on the host, outside their containers;
    # in a pod they reach nvidia-smi and NVML through the NVIDIA runtime
    # that node prep makes containerd's default on a host with cards.
    prep_script = nodeprep.render_node_prep(spec)
    gpu_branch = prep_script[prep_script.index("# --- 1.4 "):]
    gpu_branch = gpu_branch[:gpu_branch.index("\nelse\n")]
    check("nvidia-ctk runtime configure --runtime=containerd "
          "--set-as-default" in gpu_branch,
          "node prep does not set the NVIDIA container runtime")
    print("host: node prep 1.4 makes the NVIDIA container runtime "
          "containerd's default on a host with cards; the scripts below "
          "run on this host, outside their containers")
    objs = {o["metadata"]["name"]: o
            for group in bundles["operands"] for o in group}
    prep = objs["gpu-driver-prep"]["spec"]["template"]["spec"]
    scripts = ([("init", c["command"]) for c in prep["initContainers"]]
               + [("readiness", c["readinessProbe"]["exec"]["command"])
                  for c in prep["containers"] if "readinessProbe" in c])
    for role, argv in scripts:
        check(argv[:2] == ["/bin/sh", "-c"], f"driver-prep {role}: {argv}")
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=120)
        print(f"host: gpu-driver-prep {role} script: rc {proc.returncode}, "
              f"{proc.stdout.strip().splitlines()[-1:]}")
        check(proc.returncode == 0,
              f"gpu-driver-prep {role} script exited {proc.returncode}: "
              f"{proc.stdout[-1000:]} {proc.stderr[-1000:]}")
    gfd = objs["gpu-feature-discovery"]["spec"]["template"]["spec"][
        "containers"][0]
    argv = gfd["command"] + gfd["args"] + ["--oneshot", "--print"]
    env = {**os.environ, **{e["name"]: e["value"] for e in gfd["env"]
                            if "value" in e}, "NODE_NAME": "chip-smoke"}
    cli = subprocess.run(argv, capture_output=True, text=True, timeout=120,
                         env=env)
    check(cli.returncode == 0, f"{' '.join(argv)}: {cli.stderr}")
    record = json.loads(cli.stdout)
    cond = record["condition"]
    print(f"host: gpu-feature-discovery {' '.join(argv)}: condition "
          f"{cond['type']}={cond['status']} ({cond['reason']}: "
          f"{cond['message']}), gpu.count "
          f"{record['labels'][labels.COUNT]}")
    check(record["labels"] == got,
          f"gpu-feature-discovery's labels {record['labels']}")
    check((cond["type"], cond["status"]) == ("GpuReady", "True"),
          f"gpu-feature-discovery's condition {cond}")
    print(f"host: bundle step (render, lint, driver-prep scripts, "
          f"feature discovery) {time.perf_counter() - t0:.1f} s")

    objs = {o["metadata"]["name"]: o for o in bundles["jobs"][0]}
    print(f"host: rendered Jobs for {host.name}: {list(objs)}")
    runs = {}
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
            runs[job] = proc
    apply_step(spec, bundles, trace_dir)
    verify_step(spec, record, len(found), runs)


def card_host(torch):
    """(the machine's cards as discovery finds them, the host layout of
    that many of this card): the count must be the one torch sees."""
    from tpu_cluster_torch import topology
    from tpu_cluster_torch.discovery import devices

    found = devices.discover()
    count = torch.cuda.device_count()
    check(len(found) == count,
          f"discovered {len(found)} card(s), torch sees {count}")
    name = torch.cuda.get_device_name(0)
    card = topology.from_device_name(name)
    host = next((h for h in topology.HOST_TYPES.values()
                 if h.card is card and h.cards_per_host == count), None)
    check(host is not None, f"no host layout of {count} {name!r}")
    return found, host


def card_node(labels: dict, condition: dict, resource: str,
              cards: int) -> dict:
    """The card's Node as feature discovery and the kubelet publish it:
    discovery's labels, Ready and ``condition`` (GpuReady), and the
    cards as capacity and allocatable."""
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "chip-smoke", "labels": dict(labels)},
            "status": {
                "conditions": [{"type": "Ready", "status": "True"},
                               condition],
                "capacity": {resource: str(cards)},
                "allocatable": {resource: str(cards)}}}


def _load_fake_apiserver():
    """The repository's in-process fake kube-apiserver (stdlib only; it
    imports neither package), loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fake_apiserver.py")
    mod_spec = importlib.util.spec_from_file_location("fake_apiserver", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def _gated_in_order(log, groups, kubeapply) -> list:
    """Workloads created before every workload of the last earlier group
    holding any was read Ready, from the server's request log: a
    workload's create is the server-side-apply PATCH of its path, and its
    Ready read the first GET of its path or collection after that (the
    server fills a workload's status at create). Empty = gated."""
    entries = [(m, p.split("?")[0]) for m, p in log]

    def created(obj):
        path = kubeapply.object_path(obj)
        return next((i for i, (m, p) in enumerate(entries)
                     if m == "PATCH" and p == path), None)

    def read_ready(obj, after):
        paths = (kubeapply.object_path(obj), kubeapply.collection_path(obj))
        return next((i for i, (m, p) in enumerate(entries)
                     if i > after and m == "GET" and p in paths), None)

    bad, gate, gate_names = [], None, []
    for group in groups:
        work = [o for o in group if o["kind"] in kubeapply.WORKLOAD_KINDS]
        if not work:
            continue
        made = {o["metadata"]["name"]: created(o) for o in work}
        if None in made.values():
            return [f"no create of {made}"]
        if gate is not None and min(made.values()) <= gate:
            bad.append(f"{sorted(made)} created at request "
                       f"{min(made.values())}, before {gate_names} were read "
                       f"Ready (request {gate})")
        reads = [read_ready(o, made[o["metadata"]["name"]]) for o in work]
        if None in reads:
            return [f"{sorted(made)} never read after their create"]
        gate, gate_names = max(reads), sorted(made)
    return bad


def apply_step(spec, bundles, trace_dir=None) -> None:
    """The port's apply engine on the card's own stack, against the fake
    apiserver: stored, gated group by group, traced, no retries; then
    deleted. Then the CLI's REST path without PyYAML, its trace merged
    with the fake's, validated and summarized by ``top``."""
    import shutil
    import tempfile

    from tpu_cluster_torch import kubeapply, telemetry

    fake = _load_fake_apiserver()
    order = ("operands", "operator", "jobs")
    everything = [obj for what in order for group in bundles[what]
                  for obj in group]
    paths = sorted({kubeapply.object_path(o) for o in everything})
    tel = telemetry.Telemetry()
    with fake.FakeApiServer(auto_ready=True) as api:
        client = kubeapply.Client(api.url, telemetry=tel)
        try:
            t0 = time.perf_counter()
            for what in order:
                t1 = time.perf_counter()
                result = kubeapply.apply_groups(
                    client, bundles[what], wait=True, stage_timeout=60,
                    poll=0.05, lint_mode="error", lint_spec=spec,
                    apply_mode="ssa", log=lambda msg: None)
                print(f"host: apply {what}: {len(result.actions)} object(s) "
                      f"in {len(bundles[what])} group(s), "
                      f"{time.perf_counter() - t1:.2f} s; "
                      f"{result.timings_line()}")
            wall = time.perf_counter() - t0
            missing = [p for p in paths if api.get(p) is None]
            print(f"host: applied {len(paths)} object(s) in {wall:.2f} s, "
                  f"{len(api.log)} request(s), {client.retries} retried")
            check(not missing, f"applied objects absent from the store: "
                               f"{missing}")
            check(client.retries == 0, f"{client.retries} request(s) retried")
            groups = [g for what in order for g in bundles[what]]
            early = _gated_in_order(list(api.log), groups, kubeapply)
            check(not early, "a group was applied before the one before it "
                             "was read Ready: " + "; ".join(early))
            rollouts = [s for s in tel.tracer.roots if s.name == "rollout"]
            check(len(rollouts) == len(order),
                  f"{len(rollouts)} rollout span(s) for {len(order)} "
                  "bundle(s)")
            for what, span in zip(order, rollouts):
                kids = [c.name for c in span.children]
                want = [f"group-{i + 1}" for i in range(len(bundles[what]))]
                check(kids == want, f"{what}: rollout's children {kids}")
                for g in span.children:
                    phases = {c.name for c in g.children if c.cat == "phase"}
                    check({"apply", "ready-wait"} <= phases,
                          f"{what} {g.name}: phases {sorted(phases)}")
            print(f"host: trace: {len(rollouts)} rollout span(s), groups "
                  f"{[len(s.children) for s in rollouts]}, each with its "
                  "apply and ready-wait phases")
            t1 = time.perf_counter()
            for what in reversed(order):
                kubeapply.delete_groups(client, bundles[what],
                                        log=lambda msg: None)
            left = [p for p in paths if api.get(p) is not None]
            print(f"host: deleted in {time.perf_counter() - t1:.2f} s; "
                  f"{len(left)} object(s) left")
            check(not left, f"delete left {left}")
        finally:
            client.close()

    # the CLI's REST path with PyYAML made unimportable, whether or not
    # this machine has it: only the kubectl backend and `render` need it
    with fake.FakeApiServer(auto_ready=True) as api, \
            tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "apply-trace.json")
        argv = ["apply", "--apiserver", api.url, "--wait", "--poll", "0.05",
                "--trace-out", trace,
                "--flight-recorder", os.path.join(tmp, "flight.json")]
        t0 = time.perf_counter()
        proc = _port_cli(*argv)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0 and "apply: converged" in proc.stdout,
              f"{' '.join(argv)} exited {proc.returncode}: "
              f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
        with open(trace, encoding="utf-8") as f:
            cli_doc = json.load(f)
        spans = [e for e in cli_doc["traceEvents"] if e.get("ph") == "X"]
        check(any(e["name"] == "rollout" for e in spans),
              "the CLI's trace has no rollout span")
        print(f"host: python -m tpu_cluster_torch apply --apiserver URL "
              f"--wait with PyYAML blocked: rc 0, apply: converged, "
              f"{len(api.store)} object(s), {len(api.log)} request(s), "
              f"trace of {len(spans)} span(s), {wall:.2f} s")

        # the trace readers: the CLI's trace merged with the server's
        t0 = time.perf_counter()
        server = os.path.join(tmp, "server-trace.json")
        with urllib.request.urlopen(api.url + "/__fake_trace",
                                    timeout=30) as resp, \
                open(server, "wb") as f:
            f.write(resp.read())
        merged = os.path.join(tmp, "merged.json")
        runs = {"merge": _port_cli("trace", "merge", "-o", merged, trace,
                                   server),
                "validate": _port_cli("trace", "validate", merged),
                "top": _port_cli("top", trace)}
        for what, run in runs.items():
            check(run.returncode == 0, f"trace {what} exited "
                                       f"{run.returncode}: {run.stderr}")
        with open(merged, encoding="utf-8") as f:
            merged_doc = json.load(f)
        trace_id = cli_doc["otherData"]["trace_id"]
        phases = [p for p in ("apply", "crd-establish", "ready-wait")
                  if re.search(rf"^  {p} +[0-9.]+s$", runs["top"].stdout,
                               re.M)]
        print(f"host: trace merge of the CLI's and the server's traces: "
              f"{len(merged_doc['traceEvents'])} event(s) from "
              f"{merged_doc['otherData']['merged_from']}, trace ids "
              f"{merged_doc['otherData']['trace_ids']}; trace validate rc "
              f"0 ({runs['validate'].stdout.strip()}); top rc 0, phases "
              f"{phases}; {time.perf_counter() - t0:.2f} s")
        check(trace_id in merged_doc["otherData"]["trace_ids"],
              f"the merged trace lacks the CLI's trace id {trace_id}")
        check(phases == ["apply", "crd-establish", "ready-wait"],
              f"top lists the phases {phases}:\n{runs['top'].stdout}")
        if trace_dir is not None:
            shutil.copy(trace, os.path.join(trace_dir, "apply-trace.json"))


def slo_phase(trace_dir: str) -> None:
    """``slo check`` over the card's traces (the host phase's apply
    trace and the fleet phase's): healthy, with samples for all three
    SLOs; and a copy of the apply trace with every non-watch request
    answered 503 must burn ``apply-availability``."""
    t0 = time.perf_counter()
    apply_trace = os.path.join(trace_dir, "apply-trace.json")
    traces = (apply_trace, os.path.join(trace_dir, "fleet-trace.json"))
    proc = _port_cli("slo", "check", *traces)
    check(proc.returncode == 0, f"slo check over the card's traces exited "
                                f"{proc.returncode}:\n{proc.stdout}"
                                f"{proc.stderr}")
    doc = json.loads(_port_cli("slo", "check", *traces, "--json").stdout)
    samples = {v["name"]: v["samples"] for v in doc["slos"]}
    print("slo: python -m tpu_cluster_torch slo check APPLY_TRACE "
          "FLEET_TRACE with PyYAML blocked: rc 0\n" + proc.stdout.rstrip())
    print(f"slo: samples {samples}")
    check(all(samples.get(name, 0) > 0 for name in SLO_NAMES),
          f"SLO samples {samples}")
    with open(apply_trace, encoding="utf-8") as f:
        control = json.load(f)
    flipped = 0
    for e in control["traceEvents"]:
        args = e.get("args") or {}
        if e.get("ph") == "X" and e.get("cat") == "http" \
                and not args.get("watch"):
            args["status"] = 503
            flipped += 1
    path = os.path.join(trace_dir, "control-503.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(control, f)
    proc = _port_cli("slo", "check", path)
    last = proc.stdout.strip().split("\n")[-1]
    print(f"slo: control ({flipped} request(s) answered 503): rc "
          f"{proc.returncode}, {last!r}; {time.perf_counter() - t0:.2f} s")
    check(proc.returncode == 1 and re.search(
        r"apply-availability: (page \(5m/1h\)|warn \(6h/3d\))", last),
          f"the 503 control: rc {proc.returncode}, {last!r}")


def contracts_phase() -> None:
    """The port's concurrency lint and contract pin audit on this
    checkout: both clean."""
    for argv, want in ((("conlint",), "conlint: clean"),
                       (("pinlint", "--strict"), "pinlint: clean")):
        t0 = time.perf_counter()
        proc = _port_cli(*argv)
        wall = time.perf_counter() - t0
        print(f"contracts: python -m tpu_cluster_torch {' '.join(argv)}: "
              f"rc {proc.returncode}, {proc.stdout.strip()!r}, {wall:.2f} s")
        check(proc.returncode == 0 and proc.stdout.strip() == want,
              f"{' '.join(argv)}: {proc.stdout}{proc.stderr}")


def verify_step(spec, record: dict, cards: int, runs: dict) -> None:
    """``verify``'s checks against a runner that answers ``kubectl`` from
    this phase's own output, and one control that must fail."""
    from tpu_cluster_torch import verify

    ns = spec.gpu.namespace

    def runner_for(condition: dict):
        node = card_node(record["labels"], condition,
                         spec.gpu.resource_name, cards)
        nodes = json.dumps({"kind": "List", "items": [node]})
        answers = {
            ("kubectl", "get", "nodes", "-o", "json"): nodes,
            ("kubectl", "get", "nodes", "-l", verify.PRESENT_SELECTOR,
             "-o", "json"): nodes,
        }
        for job, proc in runs.items():
            done = ({"succeeded": 1} if proc.returncode == 0
                    else {"failed": 1})
            answers[("kubectl", "get", "job", "-n", ns, job, "-o",
                     "json")] = json.dumps(
                {"kind": "Job", "metadata": {"name": job},
                 "spec": {"completions": 1}, "status": done})
            # kubectl logs merges the container's streams; a piped
            # stdout is flushed at exit, after every stderr line
            answers[("kubectl", "logs", "-n", ns, f"job/{job}")] = (
                proc.stderr + proc.stdout)

        def runner(argv):
            out = answers.get(tuple(argv))
            return (1, "") if out is None else (0, out)
        return runner

    names = ["labels", "conditions", "allocatable", "device-query",
             "vector-add"]
    snapshot = verify.ClusterSnapshot(runner_for(record["condition"]))
    results = verify.run_checks(names, spec, snapshot)
    for res in results:
        print(f"host: verify {res.line()}")
    print(f"host: verify snapshot: {snapshot.fetches} kubectl call(s) "
          f"served {len(results)} check(s)")
    check([r.name for r in results] == names and all(r.ok for r in results),
          "verify failed on the card's own output: "
          + "; ".join(r.line() for r in results if not r.ok))
    control = verify.run_checks(
        ["conditions"], spec,
        runner_for({**record["condition"], "status": "False",
                    "reason": "DegradedGpuSet"}))[0]
    print(f"host: verify control (GpuReady False): {control.line()}")
    check(not control.ok, "verify's conditions check passed a node whose "
                          "GpuReady is False")


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
    import tempfile

    with tempfile.TemporaryDirectory() as traces:
        return run_phases(torch, traces)


def run_phases(torch, traces: str) -> int:
    """Every phase in order; the fleet and host phases write their
    traces into ``traces`` for the SLO phase."""
    name, acc, smi_line = device_phase(torch)
    build_phase()
    forward = flash_phase(torch, acc)
    backward = backward_phase(torch, acc)
    windowed = window_phase(torch, acc)
    decoding = decode_phase(torch, acc)
    head_phase(torch)
    served = serving_phase(torch)
    fleet = fleet_phase(torch, traces)
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
    bench_phase(smi_line)
    cross = crossover_phase(torch, smi_line)
    host_phase(torch, traces)
    slo_phase(traces)
    contracts_phase()
    # the records at d_head 256; those at 128 beside them
    k1 = forward[256]
    k1["training_shape"] = backward[256]["k1_training"]
    k1["head_dim_128"] = {**forward[128],
                          "training_shape": backward[128]["k1_training"]}
    k2, k3 = (dict(backward[256][n], head_dim_128=backward[128][n])
              for n in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"))
    for i, record in enumerate((k1, k2, k3)):
        by_path = record.setdefault("launches_by_path", {})
        by_path["training"] = training_launches[i]
        by_path["sharded"] = sharded["launches"][i]
        by_path["timed_steps"] = timed["launches"][i]
        by_path["shardbench"] = bench["launches"][i]
        by_path["crossover"] = cross[256][i]
        record["launches"] = sum(by_path.values())
        # d_head 128 runs in the crossover and in the sparse model, whose
        # windowed layers run the windowed instances
        narrow = record["head_dim_128"]
        narrow["launches_by_path"] = {
            "crossover": cross[128][i],
            "sparse_training": windowed["launches"][i]}
        narrow["launches"] = sum(narrow["launches_by_path"].values())
        narrow["window"] = windowed["records"][record["name"]]
    # the decode attention runs on the serving paths and the crossover's
    decode = dict(decoding[256], head_dim_128=decoding[128])
    decode["launches_by_path"] = {"serving": serving_launches,
                                  "autoscale": fleet["launches"],
                                  "crossover": cross[256][3]}
    decode["head_dim_128"]["launches_by_path"] = {"crossover": cross[128][3]}
    for record in (decode, decode["head_dim_128"]):
        record["launches"] = sum(record["launches_by_path"].values())
    print(json.dumps({"kernels": [k1, k2, k3, decode]}))
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
