"""The plain reference against the port's burn-in block on the CPU, at
toy sizes, and its control (the reference in fp8) against both."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import harness, serve
from portbench.drivers import train
from portbench.reference import engine_weights
from portbench.reference import model as ref
from portbench.tests.tiny import TINY_MODEL, tiny_cell

CPU = torch.device("cpu")
MEDIUM = dict(d_model=256, n_heads=2, d_head=128, d_ff=1024, vocab=4096,
              context=512, layers=1)


def _train_cell(model, seed, batch=2, seq=16):
    cell = harness.load_cell("mpt7b8k-train-s8192", seed)
    cell.config = dict(copy.deepcopy(cell.config), model=dict(model))
    cell.traffic = dict(cell.traffic, batch=batch, seq=seq, pool=4)
    return cell


def test_engine_weights_worked_out_again():
    from tpu_cluster_torch.workloads import serving

    cell = tiny_cell("gptj6b-serve-poisson")
    eng = serving.InferenceEngine(serve.engine_config(cell), device="cpu")
    mine = eng._ensure_model()[0]
    m = cell.model
    again = engine_weights.engine_params(m["d_model"], m["d_ff"], m["vocab"],
                                         CPU)
    assert list(again) == list(mine)
    for name in mine:
        assert torch.equal(again[name], mine[name]), name


@pytest.mark.cuda
def test_engine_weights_on_the_card(card):
    from tpu_cluster_torch.workloads import serving

    cell = harness.load_cell("gptj6b-serve-poisson")
    eng = serving.InferenceEngine(serve.engine_config(cell), device=card)
    mine = eng._ensure_model()[0]
    m = cell.model
    again = engine_weights.engine_params(m["d_model"], m["d_ff"], m["vocab"],
                                         card)
    for name in mine:
        assert torch.equal(again[name], mine[name]), name


def test_reference_logits_follow_the_block():
    from tpu_cluster_torch.workloads import burnin

    cell = _train_cell(TINY_MODEL, 5)
    cfg = train.step_config(cell, CPU)
    from portbench import inputs
    params = inputs.train_params(cell.model, 5, CPU)
    tokens, _ = train.batches(cell, CPU)[0]
    theirs = burnin.forward(params, tokens, cfg)
    mine = ref.logits(params, tokens, cell.model["n_heads"])
    assert mine.shape == theirs.shape
    # the block computes in bf16: a few bf16 roundings of logits of ~1
    assert (mine - theirs).abs().max() < 0.05
    assert (mine - theirs).abs().mean() < 0.01
    rows = [3, 7, 15]
    assert torch.allclose(ref.logits(params, tokens[:1], 2, rows=rows),
                          mine[0, rows], atol=1e-5)


def test_reference_in_blocks_equals_whole(monkeypatch):
    q, k, v = (torch.randn(2, 40, 2, 8) for _ in range(3))
    whole = ref.attention(q, k, v, "f32")
    monkeypatch.setattr(ref, "Q_BLOCK", 16)
    assert torch.allclose(ref.attention(q, k, v, "f32"), whole, atol=1e-6)


@pytest.mark.parametrize("model", [TINY_MODEL, MEDIUM], ids=["tiny", "medium"])
def test_training_reference_and_its_control(model):
    """Sound program readings sit far below the fp8 control's, which sit
    far below the fault's (half of the batch left out)."""
    seq = 16 if model is TINY_MODEL else 256
    for seed in (1, 2):
        cell = _train_cell(model, seed, seq=seq)
        cfg = train.step_config(cell, CPU)
        feed = train.batches(cell, CPU)
        prog = train.checked_steps(cell, CPU, cfg, feed)
        want = train.reference(cell, CPU, feed)
        sound = train.compare(prog, want)
        control = train.compare(train.reference(cell, CPU, feed, "fp8"), want)
        half = train.compare(train.reference(
            cell, CPU, feed, "f32", train.half_batch(cell, CPU)), want)
        assert max(sound.values()) < 3e-3
        for key in ("grad_gap", "change_gap"):
            assert control[key] > 5 * sound[key]
            assert half[key] > 0.2


def test_serving_reference_and_its_control():
    """The engine's greedy tokens lie within rounding of the reference's
    best; the tokens the fp8 reference puts first lie well below it."""
    cell = tiny_cell("gptj6b-serve-poisson")
    cell.config["model"] = dict(MEDIUM)
    eng = serve.start_engine(cell, CPU, (1, 2, 3))
    try:
        served = serve._serve_window(eng, cell, 1.0)
    finally:
        eng.stop()
    seqs = [(s.req.prompt, list(s.req.tokens)) for s in served[:12]]
    assert sum(len(t) for _, t in seqs) >= 30
    g = serve.gaps(cell, CPU, seqs, control=True)
    assert max(g["served"]) < 0.05
    assert max(g["control"]) > 3 * max(g["served"])


def test_calibration_judges_each_reading_by_the_cells_limits():
    """Calibration judges every control and fault as a run does: each
    comes out not correct, with the numbers beside it."""
    from portbench import calibrate

    cell = _train_cell(MEDIUM, 1, seq=256)
    rows = harness.driver(cell).calibration(cell, CPU, [1], {1}, 0.0)
    for kind in ("control", "half_batch", "state_unchanged"):
        assert rows[kind][1]["correct"] is False, (kind, rows[kind])
        assert set(rows[kind][1]["numbers"]) == set(cell.limits)
    verdict = calibrate.verdict(rows)
    assert verdict["control"] and verdict["half_batch"] \
        and verdict["state_unchanged"]
