"""The rule that sets ``burnin.FLASH_CROSSOVER_SEQ`` from a crossover
table (``kernels/crossover.pick_crossover``) on synthetic tables: a win,
a loss, a margin inside the spread, and paths or widths that disagree;
the sweep's plan (its configurations and launch count) on the CPU."""

import pytest
import torch

from tpu_cluster_torch.kernels import crossover
from tpu_cluster_torch.workloads import burnin

SEQS = (256, 512, 1024, 2048, 4096, 8192)


def _rows(ratios, path="serving", width="standard", spread=0.01):
    """One row per seq: flash at 1 ms, xla at ``ratio`` ms, both spreads
    ``spread``."""
    return [{"path": path, "width": width, "seq": s, "xla_ms": r,
             "flash_ms": 1.0, "xla_spread": spread, "flash_spread": spread}
            for s, r in zip(SEQS, ratios)]


def test_win_from_the_first_point_picks_it():
    rows = _rows([1.5] * 6)
    assert crossover.pick_crossover(rows) == (256, [("serving", "standard")])
    assert crossover.contradictions(rows, 256) == []


def test_loss_below_then_wins_picks_the_first_win():
    rows = _rows([0.5, 0.9, 1.2, 2.0, 3.0, 4.0])
    assert crossover.pick_crossover(rows)[0] == 1024
    assert [r["seq"] for r in crossover.contradictions(rows, 512)] == [512]
    assert crossover.contradictions(rows, 1024) == []


def test_margin_inside_the_spread_moves_the_pick_up():
    # 1.02 against 1.0 with spreads of 0.05: no win, and no loss either
    rows = _rows([0.8, 1.02, 1.2, 2.0, 3.0, 4.0], spread=0.05)
    assert crossover.pick_crossover(rows)[0] == 1024
    assert crossover.contradictions(rows, 512) == []
    # the larger of the two spreads counts
    rows = _rows([1.5] * 6)
    rows[0]["flash_spread"] = 0.6
    assert crossover.pick_crossover(rows)[0] == 512


def test_a_loss_above_a_win_restarts_the_run():
    rows = _rows([1.5, 1.5, 0.9, 1.5, 1.5, 1.5])
    assert crossover.pick_crossover(rows)[0] == 2048


def test_disagreeing_paths_and_widths_take_the_larger_seq():
    rows = (_rows([1.5] * 6, "serving", "standard")
            + _rows([0.9, 1.5, 1.5, 1.5, 1.5, 1.5], "training", "standard")
            + _rows([0.9, 0.9, 0.9, 1.5, 1.5, 1.5], "serving", "bench")
            + _rows([0.9, 0.9, 1.5, 1.5, 1.5, 1.5], "training", "bench"))
    assert crossover.pick_crossover(rows) == (2048, [("serving", "bench")])
    # two pairs setting it are both named
    rows += _rows([0.9, 0.9, 0.9, 1.5, 1.5, 1.5], "decode", "bench")
    assert crossover.pick_crossover(rows) == (
        2048, [("decode", "bench"), ("serving", "bench")])


def test_no_win_at_the_largest_seq_is_no_crossover():
    rows = (_rows([1.5] * 6, "serving") + _rows([1.5] * 5 + [0.9],
                                                "training"))
    assert crossover.pick_crossover(rows) == (None, [("training", "standard")])
    with pytest.raises(ValueError):
        crossover.pick_crossover([])


def test_the_constant_is_a_grid_seq_the_kernels_take():
    c = burnin.FLASH_CROSSOVER_SEQ
    assert c in crossover.SEQS
    assert c % burnin.BLOCK == 0


@pytest.mark.parametrize("path", crossover.PATHS)
def test_sweep_configurations(path):
    for name, width in crossover.widths().items():
        cfg = crossover.path_config(width, path, 1024, "flash")
        assert (cfg.seq, cfg.attention) == (1024, "flash")
        assert cfg.d_model // cfg.n_heads in burnin.SUPPORTED_HEAD_DIMS
        if path == "serving":
            assert (cfg.batch, cfg.param_dtype) == (4, "bf16")
        else:
            assert (cfg.batch, cfg.param_dtype, cfg.remat) == (1, "f32",
                                                                "none")
    assert {w.d_model // w.n_heads for w in crossover.widths().values()} \
        == {128, 256}
    with pytest.raises(ValueError):
        crossover.path_config(burnin.standard_config(), "decode", 512, "xla")


def test_sweep_launch_count_and_spread():
    calls = crossover.WARMUP + crossover.REPS
    assert crossover.point_launches("serving") == [0, 0, 0, calls]
    assert crossover.point_launches("training") == [calls, calls, calls, 0]
    assert crossover.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == 2.0


def test_arm_shapes_are_shardbenchs_one_card_arms_off_the_grid():
    from tpu_cluster_torch.workloads import shardbench

    # dp and mp at one card share the standard width at s512 b8
    assert crossover.arm_shapes() == [("standard", 512, 8)]
    arms = {a.name: a.cfg for a in shardbench.plan(1, False)}
    cfg = crossover.path_config(burnin.standard_config(), "training", 512,
                                "xla", batch=8)
    assert cfg == arms["dp"] == arms["mp"]


def test_arm_rows_enter_contradictions_but_not_the_pick():
    grid = _rows([0.9, 1.5, 1.5, 1.5, 1.5, 1.5], "training")
    arm = _rows([0.5], "training")[0]  # s256, flash twice as slow
    assert crossover.verdict(grid, [arm], 512) == (
        512, [("training", "standard")], [])
    assert crossover.verdict(grid, [arm], 256)[2] == [grid[0], arm]


def test_calls_run_on_the_cpu_at_a_tiny_width():
    tiny = burnin.BurninConfig(vocab=64, d_model=256, d_ff=128, n_heads=2,
                               seq=64, batch=2)
    dev = torch.device("cpu")
    for path in crossover.PATHS:
        params = crossover.params_for(tiny, path, dev)
        want = torch.bfloat16 if path == "serving" else torch.float32
        assert params["wq"].dtype == want
        cfg = crossover.path_config(tiny, path, 128, "flash")
        out = crossover.make_call(cfg, path, params, dev)()
        if path == "serving":
            assert out.shape == (4,)
        else:
            loss, grads = out
            assert torch.isfinite(loss) and set(grads) == set(params)
