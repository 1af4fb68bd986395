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

The readings are the cell's driver's (``calibration`` of
``drivers/<driver>.py``): training takes no window; serving runs a short
one per seed at the cell's own load. Prints one JSON document (and writes
it to ``--out``): per kind of reading and seed, the numbers and
``correct``; and under ``verdict`` whether every sound reading passed and
every other failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List

import torch

from portbench import harness


def _seeds(text: str) -> List[int]:
    out: List[int] = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


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
    rows = harness.driver(cell).calibration(cell, device, seeds, control,
                                            args.seconds)
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
