"""A cell cut to a size the CPU runs in a second."""

from __future__ import annotations

import copy
import time

import torch

from portbench import harness

TINY_MODEL = dict(d_model=32, n_heads=2, d_head=16, d_ff=64, vocab=64,
                  context=64, layers=1)


def tiny_cell(name: str, seed: int = 2 ** 31 + 17, seconds: float = 1.0
              ) -> harness.Cell:
    """``name``'s files at toy widths and lengths, with its own limits."""
    cell = harness.load_cell(name, seed, seconds)
    cell.config = dict(copy.deepcopy(cell.config), model=dict(TINY_MODEL))
    mix = copy.deepcopy(cell.traffic)
    if mix["kind"] == "train":
        mix.update(batch=2, seq=16, pool=8)
    else:
        cell.spec = dict(cell.spec, engine=dict(seq=48, slots=4,
                                                max_queue=256))
        mix.update(prompt=dict(dist="lognormal", median=8, sigma=0.8, min=2,
                               max=24),
                   output=dict(dist="lognormal", median=5, sigma=0.6, min=2,
                               max=12),
                   drain_s=60.0, warm_tokens=4)
        if mix["kind"] == "open":
            # the mix's own arrival process, at a toy rate
            mix["arrivals"] = dict(mix["arrivals"], rate_per_s=30.0,
                                   lead_in_s=0.2)
        else:
            mix["requests"] = 20000
    cell.traffic = mix
    return cell


def run_tiny(cell: harness.Cell):
    torch.manual_seed(0)
    return harness.driver(cell).run(cell, torch.device("cpu"),
                                    time.perf_counter())
