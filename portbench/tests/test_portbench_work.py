"""The model work that every share divides by, against hand-worked
numbers, and against the port's own count of a training step."""

from __future__ import annotations

import pytest

from portbench import harness, work

MPT = harness.load_cell("mpt7b8k-train-s8192")
GPTJ = harness.load_cell("gptj6b-train-s2048")


def _step(cell):
    m, t = cell.model, cell.traffic
    return work.train_step_flops(t["batch"], t["seq"], m["d_model"],
                                 m["d_ff"], m["vocab"])


def test_training_step_work_hand_worked():
    # 3 * (2*8192*(4*4096^2 + 2*4096*16384 + 4096*50432) + 4*8192^2*4096)
    assert _step(MPT) == 23_347_442_221_056
    # 3 * (2*8192*(4*4096^2 + 2*4096*16384 + 4096*50400) + 4*4*2048^2*4096)
    assert _step(GPTJ) == 20_867_098_607_616
    assert _step(MPT) == pytest.approx(23.35e12, rel=1e-3)
    assert _step(GPTJ) == pytest.approx(20.87e12, rel=1e-3)


@pytest.mark.parametrize("cell", [MPT, GPTJ], ids=["mpt", "gptj"])
def test_training_step_work_equals_the_ports_count(cell):
    from portbench.drivers import train
    import torch

    from tpu_cluster_torch.workloads import burnin

    cfg = train.step_config(cell, torch.device("cpu"))
    assert burnin.flops_per_step(cfg) == _step(cell)


def test_attention_work_hand_worked():
    w = 1 * 32 * 128 * 8192 * 8193
    assert work.causal_product_flops(1, 32, 128, 8192) == w == 274_911_461_376
    assert work.attn_fwd_flops(1, 32, 128, 8192) == 2 * w
    assert work.attn_bwd_flops(1, 32, 128, 8192) == 5 * w
    assert work.causal_product_flops(4, 16, 256, 2048) == 4 * 16 * 256 * 2048 * 2049
    # bytes: q, k, v, o in bf16 and an f32 row statistic; never the bound
    assert work.attn_fwd_bytes(1, 32, 128, 8192) == 4 * 8192 * 4096 * 2 + 32 * 8192 * 4
    assert work.attn_bwd_bytes(1, 32, 128, 8192) == 7 * 8192 * 4096 * 2 + 2 * 32 * 8192 * 4


def test_served_token_work():
    base = 2 * (4 * 4096 ** 2 + 2 * 4096 * 16384 + 4096 * 50400)
    assert work.matmul_flops_per_token(4096, 16384, 50400) == base == 815_529_984
    assert work.served_token_flops(4096, 16384, 50400, 1000) == base + 4 * 4096 * 1000


def test_roofline_share():
    # 989 TFLOP in 2 s is half the bf16 peak
    assert work.roofline_share(989e12, 0, 2.0) == pytest.approx(50.0)
    # bytes bound when they take longer
    assert work.roofline_share(0, 3.35e12, 4.0) == pytest.approx(25.0)
