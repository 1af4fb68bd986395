"""The readings that a cell's limits are set from, on the card, at the
cell's own sizes, many seeds in one process:

- the program's sound readings, one per seed: what a run compares;
- the control's: the plain reference put in the program's place and
  computed in fp8 (``reference.model``'s ``prec="fp8"``);
- the faults a cell can have, planted: for training, half of the batch
  left out (in the reference put in the program's place) and a state
  left unchanged (the program's losses with no update: no run); for
  serving, a served token altered where it is produced, and a decode
  that returns its state unchanged (the first served token again and
  again), both planted in the served answers.

Each reading is judged as a run judges it, by ``harness.judge`` and
``harness.passed`` against the limits in the cell's file: every sound
reading has to come out ``correct`` and every control and fault not.

    python3 -m portbench.calibrate --workload <cell> --seeds 1-12 \\
        --control-seeds 1-3 [--seconds 10] [--out FILE]

Training takes no window; serving runs a short one per seed at the cell's
own load. Prints one JSON document (and writes it to ``--out``): per
kind of reading and seed, the numbers and ``correct``; and under
``verdict`` whether every sound reading passed and every other failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import harness, serve, traffic
from portbench.drivers import train


def _seeds(text: str) -> List[int]:
    out: List[int] = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def _judged(cell: harness.Cell, numbers: Dict[str, float]
            ) -> Dict[str, Any]:
    checks = harness.judge(numbers, cell.limits)
    return {"numbers": numbers, "correct": harness.passed(checks)}


def training(cell: harness.Cell, device, seeds, control_seeds
             ) -> Dict[str, Any]:
    cfg = train.step_config(cell, device)
    rows: Dict[str, Any] = {"sound": {}, "control": {}, "half_batch": {},
                            "state_unchanged": {}}
    for seed in seeds:
        cell.seed = seed
        feed = train.batches(cell, device)
        prog = train.checked_steps(cell, device, cfg, feed)
        torch.cuda.empty_cache()
        want = train.reference(cell, device, feed)
        rows["sound"][seed] = _judged(cell, train.compare(prog, want))
        if seed in control_seeds:
            rows["control"][seed] = _judged(cell, train.compare(
                train.reference(cell, device, feed, "fp8"), want))
            rows["half_batch"][seed] = _judged(cell, train.compare(
                train.reference(cell, device, feed, "f32",
                                train.half_batch(cell, device)), want))
            still = train.Readings(prog.losses, {k: 0.0 for k in prog.first},
                                   {k: 0.0 for k in prog.change})
            rows["state_unchanged"][seed] = _judged(
                cell, train.compare(still, want))
        print(json.dumps({"seed": seed, **{k: v.get(seed) for k, v in
                                           rows.items()}}), file=sys.stderr)
    return rows


def _serve_window(eng, cell: harness.Cell, seconds: float) -> List[Any]:
    """One short window at the cell's load; the requests it served, all
    finished."""
    mix = cell.traffic
    plan = traffic.plan(mix, cell.seed, seconds, cell.model["vocab"],
                        cell.spec["engine"]["seq"])
    if mix["kind"] == "saturated":
        sender = serve.Sender(eng, plan, mix["deadline_s"],
                              depth=mix["queue_depth"])
        t0 = time.monotonic()
    else:
        t_base = time.monotonic() + 0.05
        sender = serve.Sender(eng, plan, mix["deadline_s"], t_base=t_base)
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


def serving(cell: harness.Cell, device, seeds, control_seeds, seconds
            ) -> Dict[str, Any]:
    mix = cell.traffic
    first = traffic.plan(mix, seeds[0], 1.0, cell.model["vocab"],
                         cell.spec["engine"]["seq"])[0]
    eng = serve.start_engine(cell, device, first.prompt)
    windows = {}
    try:
        for seed in seeds:
            cell.seed = seed
            served = _serve_window(eng, cell, seconds)
            picked = serve.sample(served, seed, mix["check_requests"])
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
        g = serve.gaps(cell, device, seqs, control=seed in control_seeds)
        rows["sound"][seed] = _served(cell, max(g["served"]))
        tokens[seed] = sum(len(t) for _, t in seqs)
        if seed in control_seeds:
            rows["control"][seed] = _served(cell, max(g["control"]))
            rows["token_altered"][seed] = _served(cell, max(
                serve.gaps(cell, device, altered)["served"]))
            rows["state_unchanged"][seed] = _served(cell, max(
                serve.gaps(cell, device, unchanged)["served"]))
        print(json.dumps({"seed": seed, "checked_tokens": tokens[seed],
                          **{k: v.get(seed) for k, v in rows.items()}}),
              file=sys.stderr)
    rows["checked_tokens"] = tokens
    return rows


def _served(cell: harness.Cell, gap: float) -> Dict[str, Any]:
    """A serving reading as a run judges it; every request answered."""
    return _judged(cell, {"served_gap": gap, "unanswered": 0.0})


def verdict(rows: Dict[str, Any]) -> Dict[str, bool]:
    """Whether every sound reading passed, and every other failed."""
    out = {}
    for kind, by_seed in rows.items():
        if kind == "checked_tokens" or not by_seed:
            continue
        want = kind == "sound"
        out[kind] = all(r["correct"] is want for r in by_seed.values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_card(cell.chips)
    device = torch.device("cuda", 0)
    seeds, control = _seeds(args.seeds), set(_seeds(args.control_seeds))
    t0 = time.perf_counter()
    if cell.traffic["kind"] == "train":
        rows = training(cell, device, seeds, control)
    else:
        rows = serving(cell, device, seeds, control, args.seconds)
    doc = {"workload": cell.name, "device": torch.cuda.get_device_name(0),
           "seconds": time.perf_counter() - t0, "limits": cell.limits,
           "verdict": verdict(rows), "readings": rows}
    text = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
