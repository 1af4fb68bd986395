"""Serving cells: the port's ``InferenceEngine`` with its own thread
running, fed through ``submit`` by the benchmark's traffic.

Set-up builds the engine at the cell's widths (it draws its own bf16
weights), warms it with one request of several decode iterations (eager
torch pays first-call costs over the first three), and brings the
traffic to its steady state before the window opens. The window is
host-clock time; the engine's stamps (``time.monotonic``) time each
request. Afterwards the plain reference judges a sample, drawn from the
seed, of the requests the window served, the longest among them: the
widest gap by which a served token's logit lies below the reference's
best at its position. A traced run builds the engine with its spans
armed (``spans=True``).
"""

from __future__ import annotations

import gc
import json
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import harness, host, inputs, spans, traffic
from portbench.reference import engine_weights
from portbench.reference import model as ref
from portbench.trace import profiled, reduce, window_span

# The numbers a run judges, each a limit of the cell's file.
COMPARED = frozenset({"served_gap", "unanswered"})
check_model = inputs.check_burnin


def program():
    from tpu_cluster_torch import telemetry
    from tpu_cluster_torch.workloads import serving
    return serving, telemetry


def engine_config(cell: harness.Cell):
    serving, _ = program()
    m, e, t = cell.model, cell.spec["engine"], cell.traffic
    return serving.ServingConfig(
        vocab=m["vocab"], d_model=m["d_model"], d_ff=m["d_ff"],
        n_heads=m["n_heads"], seq=e["seq"], slots=e["slots"],
        max_new_tokens=t["output"]["max"], default_deadline_s=t["deadline_s"],
        max_queue=e["max_queue"])


def start_engine(cell: harness.Cell, device: torch.device, warm_prompt):
    """A started engine that has run the warm-up request; with its spans
    armed in a traced run."""
    serving, telemetry = program()
    eng = serving.InferenceEngine(engine_config(cell),
                                  telemetry=telemetry.Telemetry(),
                                  device=device, spans=cell.trace).start()
    warm = eng.submit(warm_prompt, max_new_tokens=cell.traffic["warm_tokens"],
                      deadline_s=600.0)
    deadline = time.monotonic() + 600.0
    # the engine's thread may die in its first step (a kernel that fails
    # to build): then nothing finishes the request
    while not warm.done.wait(1.0) and eng._thread.is_alive() \
            and time.monotonic() < deadline:
        pass
    if warm.status != "ok":
        why = warm.status or ("unfinished" if eng._thread.is_alive()
                              else "unfinished: the engine thread died")
        eng.stop()
        raise RuntimeError(f"warm-up request ended {why}")
    return eng


@dataclass
class Sent:
    due: float
    req: Any


class Sender(threading.Thread):
    """Sends the plan: open, each request when due (``t_base + at``);
    saturated, whenever fewer than ``depth`` requests wait, looking every
    ``POLL_S``. Counts its wake-ups and, saturated, the least queue depth
    it saw since :meth:`mark`."""

    POLL_S = 0.002

    def __init__(self, eng, plan: List[traffic.Planned], deadline_s: float,
                 t_base: float = 0.0, depth: int = 0) -> None:
        super().__init__(daemon=True, name="portbench-sender")
        self.eng, self.plan, self.deadline_s = eng, plan, deadline_s
        self.t_base, self.depth = t_base, depth
        self.sent: List[Sent] = []
        self.stop = threading.Event()
        self.error: Optional[BaseException] = None
        self.wakeups = 0
        self.least_depth = depth
        # (monotonic time, the engine's decoded tokens) at the start and
        # when the plan ran out
        self.started: Tuple[float, int] = (0.0, 0)
        self.exhausted: Optional[Tuple[float, int]] = None

    def mark(self) -> None:
        self.least_depth = self.depth

    def _send(self, item: traffic.Planned, due: float) -> None:
        req = self.eng.submit(item.prompt, max_new_tokens=item.max_new,
                              deadline_s=self.deadline_s)
        self.sent.append(Sent(due, req))

    def _room(self) -> bool:
        """Wait until fewer than ``depth`` requests wait; False once
        stopped."""
        while True:
            depth = self.eng.queue_depth()
            self.least_depth = min(self.least_depth, depth)
            if depth < self.depth:
                return True
            if self.stop.wait(self.POLL_S):
                return False
            self.wakeups += 1

    def run(self) -> None:
        self.started = (time.monotonic(), self.eng.decoded_tokens)
        try:
            for item in self.plan:
                if self.depth:
                    if not self._room():
                        return
                    self._send(item, time.monotonic())
                else:
                    due = self.t_base + item.at
                    wait = due - time.monotonic()
                    if self.stop.wait(max(0.0, wait)):
                        return
                    self.wakeups += 1
                    self._send(item, due)
            self.exhausted = (time.monotonic(), self.eng.decoded_tokens)
        except BaseException as exc:  # reported by the main thread
            self.error = exc

    def ran_out(self) -> str:
        """What the plan's running out says: when, and at what rate the
        engine decoded until then."""
        (t0, n0), (t1, n1) = self.started, self.exhausted
        return (f"the traffic plan's {len(self.plan)} requests ran out "
                f"{t1 - t0:.1f} s after the first was sent, at "
                f"{(n1 - n0) / max(t1 - t0, 1e-9):.1f} decoded tokens/s")


def _snapshot(eng, sender: Sender) -> Dict[str, Any]:
    return {"decoded": eng.decoded_tokens,
            "iterations": len(eng._occupancy_samples),
            "wakeups": sender.wakeups,
            "tokens": {id(s.req): len(s.req.tokens) for s in list(sender.sent)}}


def _request_row(s: Sent) -> Dict[str, Any]:
    r = s.req
    return {"due": s.due, "submitted": r.submitted, "admitted": r.admitted_ts,
            "first": r.first_token_ts, "finished": r.finished_ts,
            "status": r.status, "tokens": len(r.tokens),
            "prompt": len(r.prompt)}


def sample(served: List[Sent], seed: int, k: int) -> List[Sent]:
    """``k`` requests drawn from ``seed``, the one with the most served
    tokens among them."""
    if not served:
        return []
    longest = max(served, key=lambda s: len(s.req.tokens))
    rest = [s for s in served if s is not longest]
    rng = np.random.default_rng(int(seed) ^ 0xC4EC)
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def gaps(cell: harness.Cell, device: torch.device,
         sequences: List[Tuple[Tuple[int, ...], List[int]]],
         control: bool = False) -> Dict[str, List[float]]:
    """Per sequence (prompt, served tokens): the widest gap by which a
    served token's reference logit lies below the reference's best at
    its position; with ``control``, the same for the token the fp8
    reference puts first."""
    ref.pin_precision()
    m = cell.model
    params = engine_weights.engine_params(m["d_model"], m["d_ff"], m["vocab"],
                                          device)
    out: Dict[str, List[float]] = {"served": [], "control": []}
    with torch.no_grad():
        for prompt, served in sequences:
            ids = torch.tensor([list(prompt) + served[:-1]], device=device)
            rows = range(len(prompt) - 1, len(prompt) - 1 + len(served))
            lg = ref.logits(params, ids, m["n_heads"], "f32", rows)
            best = lg.amax(-1)
            got = torch.tensor(served, device=device)
            out["served"].append(float((best - lg.gather(
                -1, got[:, None])[:, 0]).max()))
            if control:
                pick = ref.logits(params, ids, m["n_heads"], "fp8",
                                  rows).argmax(-1)
                out["control"].append(float((best - lg.gather(
                    -1, pick[:, None])[:, 0]).max()))
    return out


def run(cell: harness.Cell, device: torch.device, started: float):
    mix = cell.traffic
    saturated = mix["kind"] == "saturated"
    plan = traffic.plan(mix, cell.seed, cell.seconds, cell.model["vocab"],
                        cell.spec["engine"]["seq"])
    eng = start_engine(cell, device, plan[0].prompt)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if saturated:
        sender = Sender(eng, plan, mix["deadline_s"], depth=mix["queue_depth"])
    else:
        sender = Sender(eng, plan, mix["deadline_s"])
    try:
        # the profiler starts before the traffic and stops once the
        # judged requests are done: its start and stop stall the engine
        # for a moment, which no judged request may meet
        with profiled(cell.trace, eng.telemetry.tracer) as prof:
            sender.t_base = time.monotonic() + 0.05
            sender.start()
            if saturated:
                slots = cell.spec["engine"]["slots"]
                # the window opens once every slot is seated, the queue full
                while not (eng._occupancy_samples[-2:] == [slots, slots]
                           and eng.queue_depth() >= mix["queue_depth"]):
                    time.sleep(0.01)
                    if sender.error is not None:
                        raise sender.error
                    if sender.exhausted is not None:
                        raise RuntimeError(f"{sender.ran_out()}, before the "
                                           f"window opened")
                t0 = time.monotonic()
            else:
                t0 = sender.t_base + mix["arrivals"]["lead_in_s"]
            watch = host.Watch(host.thread_ids(engine=eng._thread,
                                               sender=sender))
            watch.open()
            time.sleep(max(0.0, t0 - time.monotonic()))
            with window_span():
                t0 = time.monotonic()
                setup_s = time.perf_counter() - started
                sender.mark()
                before = _snapshot(eng, sender)
                fifths = []
                for i in range(1, 6):
                    time.sleep(max(0.0, t0 + cell.seconds * i / 5
                                   - time.monotonic()))
                    fifths.append(eng.decoded_tokens)
                after = _snapshot(eng, sender)
                least_depth = sender.least_depth
                t1 = time.monotonic()
            watch.close()
            if saturated:
                judged = [s for s in list(sender.sent) if s.req.finished_ts
                          is not None and t0 <= s.req.finished_ts <= t1]
            else:
                judged = [s for s in list(sender.sent) if t0 <= s.due < t1]
                # the window's last requests finish under the same load
                drain_until = time.monotonic() + mix["drain_s"]
                while time.monotonic() < drain_until and not all(
                        s.req.done.is_set() for s in judged):
                    if sender.error is not None:
                        raise sender.error
                    time.sleep(0.01)
        occupancy = eng._occupancy_samples[before["iterations"]:
                                           after["iterations"]]
        dev_trace = reduce(prof) if prof is not None else None
    finally:
        sender.stop.set()
        sender.join(timeout=10)
        eng.stop()
    if sender.error is not None:
        raise sender.error
    if sender.exhausted is not None and sender.exhausted[0] < t1:
        raise RuntimeError(f"{sender.ran_out()}, {t1 - sender.exhausted[0]:.1f}"
                           f" s before the window closed")
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)

    window_ctx: List[int] = []
    for s in list(sender.sent):
        n0 = before["tokens"].get(id(s.req), 0)
        n1 = after["tokens"].get(id(s.req), 0)
        window_ctx.extend(len(s.req.prompt) + i for i in range(n0, n1))
    rows = [_request_row(s) for s in judged]
    unanswered = sum(1 for s in judged if not s.req.done.is_set())
    served = [s for s in judged if s.req.tokens]
    picked = sample(served, cell.seed, mix["check_requests"])
    sequences = [(s.req.prompt, list(s.req.tokens)) for s in picked]
    traced = spans.record_keys(prof, eng.telemetry.tracer)
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    served_gap = max(gaps(cell, device, sequences)["served"], default=0.0)
    checks = harness.judge({"served_gap": served_gap,
                            "unanswered": float(unanswered)}, cell.limits)
    m = cell.model
    rec = {
        "kind": "serve", "mode": mix["kind"], "setup_s": setup_s,
        "window_s": t1 - t0, "judged": rows,
        "window_ctx": window_ctx,
        "decoded_in_window": after["decoded"] - before["decoded"],
        "occupancy": occupancy,
        "slots": cell.spec["engine"]["slots"],
        "model": m, "trace": dev_trace, **traced,
    }
    failed = sum(1 for r in rows if r["status"] != "ok")
    lateness = [r["submitted"] - r["due"] for r in rows]
    notes = {"generator_late_max_s": max(lateness, default=0.0),
             "checked_requests": len(sequences),
             "checked_tokens": sum(len(t) for _, t in sequences),
             **watch.notes(),
             "engine_iterations": after["iterations"] - before["iterations"],
             # decoded tokens in each fifth of the window: a rate that
             # holds within a run and differs between runs is the host's
             "decoded_by_fifth": [int(x) for x in np.diff(
                 [before["decoded"], *fifths])],
             "sender_wakeups": after["wakeups"] - before["wakeups"]}
    if saturated:
        notes["least_queue_depth"] = least_depth
    return {"record": rec, "checks": checks,
            "correct": harness.passed(checks) and bool(sequences),
            "attempted": len(rows), "failed": failed, "memory_peak": peak,
            "trace": dev_trace, "notes": notes}


# ------------------------------------------------------------ calibration


def _serve_window(eng, cell: harness.Cell, seconds: float) -> List[Any]:
    """One short window at the cell's load; the requests it served, all
    finished."""
    mix = cell.traffic
    plan = traffic.plan(mix, cell.seed, seconds, cell.model["vocab"],
                        cell.spec["engine"]["seq"])
    if mix["kind"] == "saturated":
        sender = Sender(eng, plan, mix["deadline_s"],
                        depth=mix["queue_depth"])
        t0 = time.monotonic()
    else:
        t_base = time.monotonic() + 0.05
        sender = Sender(eng, plan, mix["deadline_s"], t_base=t_base)
        t0 = t_base + mix["arrivals"]["lead_in_s"]
    sender.start()
    time.sleep(max(0.0, t0 - time.monotonic()) + seconds)
    t1 = time.monotonic()
    if mix["kind"] == "saturated":
        sender.stop.set()
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        window = [s for s in list(sender.sent) if s.due < t1]
        if all(s.req.done.is_set() for s in window):
            break
        time.sleep(0.05)
    sender.stop.set()
    sender.join(timeout=10)
    if sender.error is not None:
        raise sender.error
    # let the rest finish, so that the next window starts on an idle engine
    while eng.queue_depth() or eng._active():
        time.sleep(0.05)
    if mix["kind"] == "saturated":
        return [s for s in sender.sent if s.req.finished_ts is not None
                and t0 <= s.req.finished_ts <= t1 and s.req.tokens]
    return [s for s in sender.sent if t0 <= s.due < t1 and s.req.tokens]


def _served(cell: harness.Cell, gap: float) -> Dict[str, Any]:
    """A serving reading as a run judges it; every request answered."""
    return harness.judged(cell, {"served_gap": gap, "unanswered": 0.0})


def calibration(cell: harness.Cell, device: torch.device, seeds,
                control_seeds, seconds: float) -> Dict[str, Any]:
    """One engine; per seed a short window of ``seconds`` at the cell's
    load and its judged sample: the program's served gap and, on
    ``control_seeds``, the fp8 control's, a served token altered and a
    decode that returns its state unchanged (the first served token again
    and again), each judged by the cell's limits."""
    mix = cell.traffic
    first = traffic.plan(mix, seeds[0], 1.0, cell.model["vocab"],
                         cell.spec["engine"]["seq"])[0]
    eng = start_engine(cell, device, first.prompt)
    windows = {}
    try:
        for seed in seeds:
            cell.seed = seed
            served = _serve_window(eng, cell, seconds)
            picked = sample(served, seed, mix["check_requests"])
            windows[seed] = [(s.req.prompt, list(s.req.tokens)) for s in picked]
    finally:
        eng.stop()
    del eng
    torch.cuda.empty_cache()
    rows: Dict[str, Any] = {"sound": {}, "control": {}, "token_altered": {},
                            "state_unchanged": {}}
    tokens: Dict[int, int] = {}
    vocab = cell.model["vocab"]
    for seed, seqs in windows.items():
        cell.seed = seed
        rng = np.random.default_rng(seed)
        altered, unchanged = [], []
        for prompt, toks in seqs:
            i = int(rng.integers(len(toks)))
            bad = list(toks)
            bad[i] = (bad[i] + 1 + int(rng.integers(vocab - 1))) % vocab
            altered.append((prompt, bad))
            unchanged.append((prompt, [toks[0]] * len(toks)))
        g = gaps(cell, device, seqs, control=seed in control_seeds)
        rows["sound"][seed] = _served(cell, max(g["served"]))
        tokens[seed] = sum(len(t) for _, t in seqs)
        if seed in control_seeds:
            rows["control"][seed] = _served(cell, max(g["control"]))
            rows["token_altered"][seed] = _served(cell, max(
                gaps(cell, device, altered)["served"]))
            rows["state_unchanged"][seed] = _served(cell, max(
                gaps(cell, device, unchanged)["served"]))
        print(json.dumps({"seed": seed, "checked_tokens": tokens[seed],
                          **{k: v.get(seed) for k, v in rows.items()}}),
              file=sys.stderr)
    rows["checked_tokens"] = tokens
    return rows
