"""Find the knee of an open-loop serving cell once, on the card: the
highest arrival rate the engine sustains without a growing backlog.

    python3 -m portbench.sweep --workload <cell> --rates 6,8,10,12 \\
        [--seconds 20] [--seed 1] [--out FILE]

One engine; for each rate the cell's traffic at that rate, from a
lead-in through a window of ``--seconds``: requests due, finished and
waiting at the window's start and end, and the time to first token of
the requests due in the window. The cell file then records 4/5 of the
knee as its rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness, serve, traffic
from portbench.stats import MISS, percentile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, args.seed)
    harness.require_card(cell.chips)
    device = torch.device("cuda", 0)
    mix = cell.traffic
    seq = cell.spec["engine"]["seq"]
    first = traffic.plan(mix, args.seed, 1.0, cell.model["vocab"], seq)[0]
    eng = serve.start_engine(cell, device, first.prompt)
    rows = []
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            arr = dict(mix["arrivals"], rate_per_s=rate)
            plan = traffic.plan(dict(mix, arrivals=arr), args.seed,
                                args.seconds, cell.model["vocab"], seq)
            t_base = time.monotonic() + 0.05
            sender = serve.Sender(eng, plan, mix["deadline_s"], t_base=t_base)
            sender.start()
            t0 = t_base + arr["lead_in_s"]
            time.sleep(max(0.0, t0 - time.monotonic()))
            q0, it0, tok0 = eng.queue_depth(), eng.iterations, eng.decoded_tokens
            time.sleep(args.seconds)
            q1, it1, tok1 = eng.queue_depth(), eng.iterations, eng.decoded_tokens
            t1 = time.monotonic()
            sender.stop.set()
            sender.join(timeout=10)
            due = [s for s in sender.sent if t0 <= s.due < t1]
            done_by_t1 = [s for s in due if s.req.finished_ts is not None
                          and s.req.finished_ts <= t1]
            while any(not s.req.done.is_set() for s in sender.sent):
                time.sleep(0.05)
            ttft = [s.req.first_token_ts - s.due if s.req.status == "ok"
                    else MISS for s in due]
            row = {"rate": rate, "due": len(due), "finished_by_close":
                   len(done_by_t1), "queue_start": q0, "queue_end": q1,
                   "iterations_per_s": (it1 - it0) / (t1 - t0),
                   "tokens_per_s": (tok1 - tok0) / (t1 - t0),
                   "ttft_p50_ms": 1e3 * percentile(ttft, 50),
                   "ttft_p95_ms": 1e3 * percentile(ttft, 95)}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr)
            while eng.queue_depth() or eng._active():
                time.sleep(0.05)
    finally:
        eng.stop()
    doc = {"workload": cell.name, "device": torch.cuda.get_device_name(0),
           "seconds": args.seconds, "rows": rows}
    text = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
