"""Training cells of the sparse decoder (``tpu_cluster_torch.workloads.
sparse``): the window loops the port's ``burnin.train_step`` on a
``SparseConfig`` from the seed's parameters, as ``train`` does for the
burn-in block, and its run is judged the same way, by ``train.Watch`` and
``train.compare`` against ``reference/sparse.py``, and beside that by the
routed pairs the expert layers' grouped products did not compute with
their own expert (``dropped_tokens``), which the program counts on the
device and the window never waits on. The layer has no capacity, so a
sound program reads 0: the count holds each pair's row to its expert's
group, which a capacity, or a wrong sort or offset, would break.

The loss is not judged here: its gap reads as high on sound seeds as
on the fp8 control (up to 1.2e-4 against 1.4e-4 on an H100), so it
cannot tell them apart; the gradients and the change after three steps
can (up to 0.0097 against 0.026), and every planted fault moves them.
Each run's ``loss_gap`` is printed as a note.

Token ids follow a Zipf law (``inputs_sparse.zipf_batches``), so the
router sees the uneven load of real text. A traced run records the
window's steps and expert layers as the port's spans, and the record
carries the model work of the attention and of the expert products for
their readers.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from typing import Any, Dict, Optional

import torch

from portbench import harness, host, inputs_sparse, spans, work_sparse
from portbench.drivers.train import Readings, Watch, compare, half_batch
from portbench.reference import model as ref_model
from portbench.reference import sparse as ref
from portbench.trace import profiled, reduce, window_span

COMPARED = frozenset({"grad_gap", "change_gap", "dropped_tokens"})
check_model = inputs_sparse.check_sparse


def program():
    """The port's trainer and its sparse model (a port without the model
    fails here, before anything is built)."""
    from tpu_cluster_torch.workloads import burnin, sparse
    return burnin, sparse


def step_config(cell: harness.Cell):
    _, sparse = program()
    m = cell.model
    return sparse.SparseConfig(
        vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"], d_head=m["d_head"],
        n_experts=m["n_experts"], top_k=m["top_k"], d_expert=m["d_expert"],
        layer_types=tuple(m["layer_types"]), window=m["window"],
        rope_theta=m["rope_theta"], yarn=sparse.Yarn(**m["yarn"]),
        norm_eps=m["norm_eps"], lr=cell.config["train"]["lr"])


def counters_for(cell: harness.Cell, device: torch.device):
    _, sparse = program()
    return sparse.RouteCounters(cell.model["layers"],
                                cell.model["n_experts"], device)


def batches(cell: harness.Cell, device: torch.device):
    m, t = cell.model, cell.traffic
    return inputs_sparse.zipf_batches(
        m["vocab"], t["batch"], t["seq"], t["pool"], t["zipf"]["exponent"],
        t["base_seed"], cell.seed, device)


def checked_steps(cell: harness.Cell, device: torch.device, cfg, feed,
                  counters) -> Readings:
    """The program's first steps from the seed's parameters, outside any
    window: what a run reads in its window, for calibration."""
    burnin, _ = program()
    p = inputs_sparse.train_params(cell.model, cell.seed, device)
    watch = Watch(p, cell.traffic["checked_steps"], cfg.lr)
    for i in range(cell.traffic["checked_steps"]):
        p, loss = burnin.train_step(p, feed[i], cfg, counters=counters)
        watch.step(p, loss)
    return watch.readings()


def reference(cell: harness.Cell, device: torch.device, feed,
              prec: str = "f32", keep: Optional[torch.Tensor] = None,
              fault: Optional[str] = None) -> Readings:
    ref_model.pin_precision()
    params0 = inputs_sparse.train_params(cell.model, cell.seed, device)
    n = cell.traffic["checked_steps"]
    losses, first, change = ref.sgd(params0, feed[:n], cell.model,
                                    cell.config["train"]["lr"], prec, keep,
                                    fault)
    return Readings(losses, first, change)


def numbers(prog: Readings, want: Readings, dropped: int) -> Dict[str, float]:
    """What a run judges, and the loss's gap, which it only reports."""
    return {**compare(prog, want), "dropped_tokens": float(dropped)}


def judged(cell: harness.Cell, got: Dict[str, float]) -> Dict[str, Any]:
    """A calibration reading judged by the cell's limits, the loss's gap
    beside it."""
    return {**harness.judged(cell, {k: got[k] for k in COMPARED}),
            "loss_gap": got["loss_gap"]}


def calibration(cell: harness.Cell, device: torch.device, seeds,
                control_seeds, seconds: float) -> Dict[str, Any]:
    """Per seed, the program's sound readings and, on ``control_seeds``,
    the fp8 control's, and the faults planted in the reference put in the
    program's place: half of the batch left out, the window ignored (full
    causal attention on the sliding layers), one expert fewer a token;
    and a state left unchanged (the program's losses with no update).
    Each judged by the cell's limits. ``seconds`` is unused."""
    counters = counters_for(cell, device)
    cfg = step_config(cell)
    rows: Dict[str, Any] = {"sound": {}, "control": {}, "half_batch": {},
                            "window_ignored": {}, "top_k_less_one": {},
                            "state_unchanged": {}}
    for seed in seeds:
        cell.seed = seed
        feed = batches(cell, device)
        counters.reset()
        prog = checked_steps(cell, device, cfg, feed, counters)
        dropped = counters.read()["dropped_tokens"]
        torch.cuda.empty_cache()
        want = reference(cell, device, feed)
        rows["sound"][seed] = judged(cell, numbers(prog, want, dropped))
        if seed in control_seeds:
            planted = {
                "control": reference(cell, device, feed, "fp8"),
                "half_batch": reference(cell, device, feed, "f32",
                                        half_batch(cell, device)),
                "window_ignored": reference(cell, device, feed,
                                            fault="window_ignored"),
                "top_k_less_one": reference(cell, device, feed,
                                            fault="top_k_less_one"),
                "state_unchanged": Readings(
                    prog.losses, {k: 0.0 for k in prog.first},
                    {k: 0.0 for k in prog.change})}
            for kind, readings in planted.items():
                rows[kind][seed] = judged(cell,
                                          numbers(readings, want, 0))
        print(json.dumps({"seed": seed, **{k: v.get(seed) for k, v in
                                           rows.items()}}), file=sys.stderr)
    return rows


def _record_work(cell: harness.Cell) -> Dict[str, Any]:
    m, t = cell.model, cell.traffic
    b, s = t["batch"], t["seq"]
    return {"layers": m["layers"], "tokens_per_step": b * s,
            "flops_per_step": work_sparse.train_step_flops(b, s, m),
            "attn_fwd_flops_per_step": work_sparse.attn_fwd_flops(b, s, m),
            "attn_bwd_flops_per_step": work_sparse.attn_bwd_flops(b, s, m),
            "attn_fwd_bytes_per_step": work_sparse.attn_fwd_bytes(b, s, m),
            "attn_bwd_bytes_per_step": work_sparse.attn_bwd_bytes(b, s, m),
            "expert_flops_per_step": work_sparse.expert_train_flops(b, s,
                                                                    m)}


def run(cell: harness.Cell, device: torch.device, started: float):
    burnin, _ = program()
    tel = None
    if cell.trace:
        from tpu_cluster_torch import telemetry
        tel = telemetry.Telemetry()
    counters = counters_for(cell, device)
    cfg = step_config(cell)
    feed = batches(cell, device)
    p = inputs_sparse.train_params(cell.model, cell.seed, device)
    warm = {k: v.clone() for k, v in p.items()}
    for i in range(cell.traffic["warm_steps"]):
        warm, loss = burnin.train_step(warm, feed[i % len(feed)], cfg,
                                       counters=counters)
    del warm, loss
    counters.reset()
    watch = Watch(p, cell.traffic["checked_steps"], cfg.lr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    steps = 0
    seen = host.Watch(host.thread_ids())
    with profiled(cell.trace, tel and tel.tracer) as prof:
        seen.open()
        with window_span():
            t0 = time.perf_counter()
            setup_s = t0 - started
            while True:
                p, loss = burnin.train_step(p, feed[steps % len(feed)], cfg,
                                            telemetry=tel,
                                            counters=counters)
                steps += 1
                watch.step(p, loss)
                if steps >= watch.n \
                        and time.perf_counter() - t0 >= cell.seconds:
                    break
            last = float(loss)  # the sync that ends the window
            window_s = time.perf_counter() - t0
        seen.close()
    dev_trace = reduce(prof) if prof is not None else None
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    counted = counters.read()
    del p, loss, counters, cfg
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    prog = watch.readings()
    del watch
    got = numbers(prog, reference(cell, device, feed),
                  counted["dropped_tokens"])
    checks = harness.judge({k: got[k] for k in COMPARED}, cell.limits)
    rec = {"kind": "train", "setup_s": setup_s, "window_s": window_s,
           "steps": steps, **_record_work(cell), "trace": dev_trace,
           **spans.record_keys(prof, tel and tel.tracer)}
    notes = {**seen.notes(), "loss_gap": got["loss_gap"],
             **{k: v for k, v in counted.items() if k != "dropped_tokens"}}
    if "timeline" in rec:
        from portbench.metrics import _moe
        notes["moe_share_forward_only"] = _moe.moe_share(rec, ("fwd",))
    ok = math.isfinite(last)
    return {"record": rec, "checks": checks,
            "correct": ok and harness.passed(checks), "attempted": steps,
            "failed": 0 if ok else 1, "memory_peak": peak, "trace": dev_trace,
            "notes": notes}
