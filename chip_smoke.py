#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``tpu_cluster_torch``) on one
NVIDIA card. Run from the repository root: ``python3 chip_smoke.py``.

It drives the port's main path — the serving engine answering HTTP
requests with the burn-in transformer at GPT-J block width (d4096,
f16384, h16, vocab 8192), seq 8192, 4 slots, random weights from seed 0
— and holds every kernel on that path against its plain PyTorch version
on the card. Phases, each fatal when it fails:

1. device: name, and name and power limit as nvidia-smi reports them;
2. build: every kernel from ``tpu_cluster_torch/csrc`` with nvcc;
3. kernels: each kernel against its plain version at the stated shapes
   and tolerances, and its time at the serving shape beside its bound,
   the plain version's time and one PyTorch library call's time;
4. serving: ``ServingServer`` answers concurrent ``POST /v1/generate``
   requests; the kernel launch counts of that run must cover the engine's
   iterations; the metrics scrape must agree with the engine; one
   request's logits are recomputed with the plain attention path and
   compared with the kernel path;
5. profile: device time by kernel for one decode iteration.

The line before the last is a JSON object of the kernels' numbers; the
last is ``{"ok": true, "device": {...}}``. Without a card, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

SEED = 0
# (B, H, S, D) of the kernel checks; the last is the serving shape.
CHECK_SHAPES = ((1, 16, 2048, 256), (2, 8, 1024, 128), (4, 16, 8192, 256))
# Kernel against its plain version, bf16 outputs: the running max rounds
# P to bf16 differently from the plain version's single max, so a value
# may land one bf16 ulp away (1.6e-2 at magnitudes in [2, 4)); the mean
# error must stay far below that.
KERNEL_MAX_ABS = 1.6e-2
KERNEL_MEAN_ABS = 2e-4
# f32 logits of the kernel path against the plain attention path: bf16
# rounding differences in the attention output propagate through the
# block (the same bound as the CPU parity tests).
LOGIT_ATOL = 5e-2
# H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
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


def device_phase(torch) -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"device: {name}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    print(smi.stdout.strip().splitlines()[0])
    return name


def build_phase() -> None:
    from tpu_cluster_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {len(_build.SOURCES)} kernel source(s) ready in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def flash_phase(torch) -> dict:
    """The flash-attention kernel against its plain version at every
    check shape; timings at the serving shape."""
    import torch.nn.functional as F

    from tpu_cluster_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = {}
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
        if (b, h, s, d) != CHECK_SHAPES[-1]:
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
        flop_ms = flops / PEAK_BF16_FLOPS * 1e3
        byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        record = {
            "name": "flash_attn_fwd", "route": "cuda",
            "source": "tpu_cluster_torch/csrc/flash_attn_fwd.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py"
                        ":758 (_flash_attention_impl, reached from "
                        "tpu_cluster/workloads/burnin.py:220)",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": library_ms,
        }
        print(f"flash_attn_fwd B{b} H{h} S{s} D{d}: kernel {ms:.3f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), bound {record['bound_ms']:.3f}"
              f" ms ({record['bound_by']}), plain {plain_ms:.3f} ms, "
              f"SDPA {library_ms:.3f} ms")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return record


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


def profile_phase(torch, served: dict) -> None:
    """Device time by kernel over one decode iteration at the serving
    shape (four full slots)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    cfg = served["engine"].cfg
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, cfg.vocab, (cfg.slots, cfg.seq)).astype(np.int32)
    pos = np.full((cfg.slots,), cfg.seq - 1, np.int32)
    served["decode"](served["params"], tokens, pos)  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        served["decode"](served["params"], tokens, pos)
        wall_ms = (time.perf_counter() - t0) * 1e3
    def device_us(e) -> float:
        # the attribute's name changed across torch releases
        return float(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0.0))

    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(device_us(e) for e in rows) / 1e3
    print(f"profile: one decode iteration {wall_ms:.1f} ms wall, "
          f"{total:.1f} ms device time by kernel:")
    for e in sorted(rows, key=lambda e: -device_us(e))[:8]:
        ms = device_us(e) / 1e3
        print(f"  {ms:8.2f} ms  {100 * ms / max(total, 1e-9):5.1f}%  "
              f"x{e.count}  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    # the port must sit beside this script; nothing is printed without it
    import tpu_cluster_torch.workloads.serving  # noqa: F401
    name = device_phase(torch)
    build_phase()
    record = flash_phase(torch)
    served = serving_phase(torch)
    record["launches"] = served["launches"]
    try:
        profile_phase(torch, served)
    except Exception as err:  # noqa: BLE001 — informational phase only
        print(f"profile: not measured ({type(err).__name__}: {err})")
    print(json.dumps({"kernels": [record]}))
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
