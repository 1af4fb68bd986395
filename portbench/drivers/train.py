"""Training cells: the window loops the port's ``burnin.train_step`` from
the seed's parameters.

Set-up makes the f32 master parameters and a pool of token batches from
the seed, and warms the step up on a copy of the parameters, which it
then throws away. The window starts from the seed's parameters, and its
own first ``checked_steps`` are the ones the reference follows: their
losses, each leaf's first gradient as the update shows it
(``|p0 - p1| / lr``) and each leaf's change after them are taken inside
the window, as device tensors, from a copy of the parameters the window
starts from. Afterwards the plain reference runs those steps again from
the seed's parameters and the same batches. A traced run records the
window's steps as the port's spans (``telemetry=``).
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional

import torch

from portbench import harness, host, inputs, spans, work
from portbench.reference import model as ref
from portbench.trace import profiled, reduce, window_span

# A leaf whose reference gradient is below this share of the median
# leaf's moves by round-off alone and is not compared.
NEGLIGIBLE_GRAD = 1e-3

# The numbers a run judges (``compare``), each a limit of the cell's file.
COMPARED = frozenset({"loss_gap", "grad_gap", "change_gap"})
check_model = inputs.check_burnin


@dataclass
class Readings:
    losses: List[float]
    first: Dict[str, float]      # per leaf: norm of the first gradient
    change: Dict[str, float]     # per leaf: norm of the change


def program():
    from tpu_cluster_torch.workloads import burnin
    return burnin


def step_config(cell: harness.Cell, device: torch.device):
    burnin = program()
    m, t = cell.model, cell.traffic
    cfg = burnin.BurninConfig(vocab=m["vocab"], d_model=m["d_model"],
                              d_ff=m["d_ff"], n_heads=m["n_heads"],
                              seq=t["seq"], batch=t["batch"],
                              lr=cell.config["train"]["lr"], param_dtype="f32")
    return replace(cfg, attention=burnin.select_attention(cfg, device.type))


def batches(cell: harness.Cell, device: torch.device):
    m, t = cell.model, cell.traffic
    return inputs.token_batches(m["vocab"], t["batch"], t["seq"], t["pool"],
                                cell.seed, device)


class Watch:
    """The readings of the first ``n`` steps from ``params``, taken as the
    steps run: a copy of the parameters the steps start from (so a step
    that updates in place still reads right), each step's loss, and
    per leaf the norm of the first update over ``lr`` and of the change
    after step ``n``, as device tensors; nothing waits on the device."""

    def __init__(self, params, n: int, lr: float) -> None:
        self.start = {k: v.detach().clone() for k, v in params.items()}
        self.n, self.lr = n, lr
        self.losses: List[torch.Tensor] = []
        self.first: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, torch.Tensor] = {}

    def _norms(self, p):
        return {k: torch.linalg.vector_norm(
            p[k].detach().float() - self.start[k].float(),
            dtype=torch.float64) for k in self.start}

    def step(self, p, loss) -> None:
        """After each step, with its new parameters and its loss."""
        if len(self.losses) >= self.n:
            return
        self.losses.append(loss.detach().to(torch.float64))
        if len(self.losses) == 1:
            self.first = {k: v / self.lr for k, v in self._norms(p).items()}
        if len(self.losses) == self.n:
            self.change = self._norms(p)
            self.start = {}

    def readings(self) -> Readings:
        if len(self.losses) < self.n:
            raise RuntimeError(f"{len(self.losses)} of {self.n} checked "
                               "steps ran")
        return Readings([float(x) for x in self.losses],
                        {k: float(v) for k, v in self.first.items()},
                        {k: float(v) for k, v in self.change.items()})


def checked_steps(cell: harness.Cell, device: torch.device, cfg, feed
                  ) -> Readings:
    """The program's first steps from the seed's parameters, outside any
    window: what a run reads in its window, for calibration."""
    burnin = program()
    p = inputs.train_params(cell.model, cell.seed, device)
    watch = Watch(p, cell.traffic["checked_steps"], cfg.lr)
    for i in range(cell.traffic["checked_steps"]):
        p, loss = burnin.train_step(p, feed[i], cfg)
        watch.step(p, loss)
    return watch.readings()


def half_batch(cell: harness.Cell, device: torch.device) -> torch.Tensor:
    """The fault "half of the batch left out": the first half of the rows,
    or of the positions where the batch is one row."""
    b, s = cell.traffic["batch"], cell.traffic["seq"]
    keep = torch.zeros((b, s), dtype=torch.bool, device=device)
    if b > 1:
        keep[: b // 2] = True
    else:
        keep[:, : s // 2] = True
    return keep


def reference(cell: harness.Cell, device: torch.device, feed,
              prec: str = "f32", keep: Optional[torch.Tensor] = None
              ) -> Readings:
    ref.pin_precision()
    params0 = inputs.train_params(cell.model, cell.seed, device)
    n = cell.traffic["checked_steps"]
    losses, first, change = ref.sgd(params0, feed[:n], cell.model["n_heads"],
                                    cell.config["train"]["lr"], prec, keep)
    return Readings(losses, first, change)


def compare(prog: Readings, want: Readings) -> Dict[str, float]:
    """The numbers compared: the widest relative gap of a step's loss;
    and, by the worst leaf, the gap between the program's and the
    reference's norms of the first gradient and of the change, against
    the reference's norm of that leaf or of the median leaf, whichever
    is larger."""
    med_g = statistics.median(want.first.values())
    leaves = [k for k, g in want.first.items() if g >= NEGLIGIBLE_GRAD * med_g]
    med_c = statistics.median(want.change[k] for k in leaves)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog.losses, want.losses)),
        "grad_gap": max(abs(prog.first[k] - want.first[k])
                        / max(want.first[k], med_g) for k in leaves),
        "change_gap": max(abs(prog.change[k] - want.change[k])
                          / max(want.change[k], med_c) for k in leaves),
    }


def calibration(cell: harness.Cell, device: torch.device, seeds,
                control_seeds, seconds: float) -> Dict[str, Any]:
    """Per seed, the program's sound readings and, on ``control_seeds``,
    the fp8 control's, half of the batch left out (in the reference put
    in the program's place) and a state left unchanged (the program's
    losses with no update), each judged by the cell's limits. Training
    takes no window: ``seconds`` is unused."""
    cfg = step_config(cell, device)
    rows: Dict[str, Any] = {"sound": {}, "control": {}, "half_batch": {},
                            "state_unchanged": {}}
    for seed in seeds:
        cell.seed = seed
        feed = batches(cell, device)
        prog = checked_steps(cell, device, cfg, feed)
        torch.cuda.empty_cache()
        want = reference(cell, device, feed)
        rows["sound"][seed] = harness.judged(cell, compare(prog, want))
        if seed in control_seeds:
            rows["control"][seed] = harness.judged(cell, compare(
                reference(cell, device, feed, "fp8"), want))
            rows["half_batch"][seed] = harness.judged(cell, compare(
                reference(cell, device, feed, "f32",
                          half_batch(cell, device)), want))
            still = Readings(prog.losses, {k: 0.0 for k in prog.first},
                             {k: 0.0 for k in prog.change})
            rows["state_unchanged"][seed] = harness.judged(
                cell, compare(still, want))
        print(json.dumps({"seed": seed, **{k: v.get(seed) for k, v in
                                           rows.items()}}), file=sys.stderr)
    return rows


def run(cell: harness.Cell, device: torch.device, started: float):
    burnin = program()
    tel = None
    if cell.trace:
        from tpu_cluster_torch import telemetry
        tel = telemetry.Telemetry()
    cfg = step_config(cell, device)
    feed = batches(cell, device)
    p = inputs.train_params(cell.model, cell.seed, device)
    warm = {k: v.clone() for k, v in p.items()}
    for i in range(cell.traffic["warm_steps"]):
        warm, loss = burnin.train_step(warm, feed[i % len(feed)], cfg)
    del warm, loss
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
                                            telemetry=tel)
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
    del p, loss
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    prog = watch.readings()
    del watch
    numbers = compare(prog, reference(cell, device, feed))
    checks = harness.judge(numbers, cell.limits)
    m, t = cell.model, cell.traffic
    rec = {
        "kind": "train", "setup_s": setup_s, "window_s": window_s,
        "steps": steps, "layers": 1,
        "tokens_per_step": t["batch"] * t["seq"],
        "flops_per_step": work.train_step_flops(
            t["batch"], t["seq"], m["d_model"], m["d_ff"], m["vocab"]),
        "attn_shape": (t["batch"], m["n_heads"], m["d_model"] // m["n_heads"],
                       t["seq"]),
        "trace": dev_trace,
        **spans.record_keys(prof, tel and tel.tracer),
    }
    ok = math.isfinite(last)
    return {"record": rec, "checks": checks,
            "correct": ok and harness.passed(checks), "attempted": steps,
            "failed": 0 if ok else 1, "memory_peak": peak, "trace": dev_trace,
            "notes": seen.notes()}
