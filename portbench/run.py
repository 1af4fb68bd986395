"""Run one cell of the benchmark once, on the card, and print its line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number that decided ``correct``, beside its limit (also the last lines
of standard error). Without a card, with fewer cards than the cell asks
for, without the port beside it, or with a JAX module loaded, it prints
no result and exits non-zero.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, host

    cell = harness.load_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    harness.pin_caches()
    placed = host.placement()
    try:
        harness.require_card(cell.chips)
    except harness.NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    try:
        import tpu_cluster_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the port is not beside the benchmark: {exc}",
              file=sys.stderr)
        return 2

    import torch

    out = harness.driver(cell).run(cell, torch.device("cuda", 0), STARTED)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: JAX modules loaded in the run: {loaded}",
              file=sys.stderr)
        return 3
    section = "per_layer" if cell.trace else "end_to_end"
    metrics = harness.read_metrics(cell.name, section, out["record"])
    device = harness.device_info(out["memory_peak"], out["trace"])
    breakdown = out["trace"].breakdown() if out["trace"] is not None else None
    for key, value in {**placed, **out.get("notes", {})}.items():
        print(f"note {key}: {value!r}", file=sys.stderr)
    print(harness.check_lines(out["checks"]), file=sys.stderr)
    print(harness.result_line(out["correct"], out["attempted"], out["failed"],
                              metrics, device, out["checks"], breakdown))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
