"""Each driver's ``calibration``, as ``portbench.calibrate`` calls it, on
tiny cells: the control and every planted fault come out not correct,
well apart from the sound readings, each judged on the numbers the
driver compares."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, harness
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")

# serving at a width where the fp8 control's tokens differ from the
# engine's
MEDIUM = dict(d_model=256, n_heads=2, d_head=128, d_ff=1024, vocab=4096,
              context=512, layers=1)

FAULTS = {"train": {"control", "half_batch", "state_unchanged"},
          "serve": {"control", "token_altered", "state_unchanged"}}


@pytest.mark.parametrize("name", ["gptj6b-train-s2048",
                                  "gptj6b-serve-poisson",
                                  "mpt7b8k-serve-offline"])
def test_calibration_through_the_driver_separates_sound_from_faults(name):
    seeds, control = [2 ** 31 + 9, 2 ** 31 + 10], {2 ** 31 + 9}
    torch.manual_seed(0)
    cell = tiny_cell(name)
    kind = "train" if cell.traffic["kind"] == "train" else "serve"
    if kind == "serve":
        cell.config["model"] = dict(MEDIUM)
    drv = harness.driver(cell)
    rows = drv.calibration(cell, CPU, seeds, control, 1.0)
    assert set(rows["sound"]) == set(seeds)
    for fault in FAULTS[kind]:
        assert set(rows[fault]) == control, fault
    for by_seed in (rows[k] for k in {"sound"} | FAULTS[kind]):
        for reading in by_seed.values():
            assert set(reading["numbers"]) == drv.COMPARED == set(cell.limits)
    if kind == "serve":
        assert all(n > 0 for n in rows["checked_tokens"].values())
    verdict = calibrate.verdict(rows)
    assert all(verdict[fault] for fault in FAULTS[kind]), verdict
    # the CPU runs the block without the card's kernels, so the sound
    # readings are not held to the card's limits here: each fault reads
    # three times the sound reading of its seed or more, in some number
    for fault in FAULTS[kind]:
        for seed, reading in rows[fault].items():
            sound = rows["sound"][seed]["numbers"]
            assert any(v >= 3 * sound[k] and v > 0
                       for k, v in reading["numbers"].items()), (fault, seed)
