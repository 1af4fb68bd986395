"""The port's training-throughput measurement against the JAX reference:
``burnin.flops_per_step`` (the model FLOPs of one step) against the
closed form and against the reference's XLA cost analysis, and
``burnin.timed_steps`` against the reference's ``timed_steps`` (result
keys, timing points) on the CPU."""

from dataclasses import replace

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from tpu_cluster.workloads import burnin as ref
from tpu_cluster_torch.workloads import burnin as port
from tpu_cluster_torch.workloads import runtime_metrics


def _closed_form(cfg) -> int:
    """One block's products (4 D^2 projections, 2 D F of the FFN, D V of
    the LM head, 4 S D of attention at full S^2 per token), forward (1)
    and backward (2), 2 FLOPs a multiply-add."""
    b, s, d, f, v = cfg.batch, cfg.seq, cfg.d_model, cfg.d_ff, cfg.vocab
    return 3 * (2 * b * s * (4 * d * d + 2 * d * f + d * v)
                + 4 * b * s * s * d)


WIDTHS = {
    "default": port.BurninConfig(),
    "d256_s256": port.BurninConfig(vocab=256, d_model=256, d_ff=1024,
                                   n_heads=2, seq=256, batch=2),
    "d1024_s512": port.BurninConfig(vocab=8192, d_model=1024, d_ff=4096,
                                    n_heads=4, seq=512, batch=1),
    "standard": port.standard_config(),
    # the training drive of chip_smoke.py: GPT-J block width, s8192, b1
    "training_s8192": replace(port.standard_config(), seq=8192, batch=1),
}


@pytest.mark.parametrize("cfg", WIDTHS.values(), ids=list(WIDTHS))
def test_flops_per_step_is_the_closed_form(cfg):
    assert port.flops_per_step(cfg) == _closed_form(cfg)


def test_flops_per_step_at_the_training_shape():
    cfg = WIDTHS["training_s8192"]
    assert port.flops_per_step(cfg) == 14_843_406_974_976


@pytest.mark.parametrize("knobs", [
    dict(remat="full"), dict(remat="dots"), dict(attention="flash"),
    dict(attention="chunked", attn_block=64), dict(param_dtype="bf16"),
], ids=["remat_full", "remat_dots", "flash", "chunked", "bf16_params"])
def test_flops_per_step_counts_model_work_only(knobs):
    """Recomputation and the attention implementation add no model work:
    the count is the no-remat ``xla`` path's whatever the knobs say."""
    cfg = WIDTHS["d256_s256"]
    assert port.flops_per_step(replace(cfg, **knobs)) == _closed_form(cfg)


def _reference_cost_flops(cfg) -> float:
    """The reference's XLA cost analysis of one no-remat train step (the
    count its ``timed_steps`` uses), from shapes only."""
    rcfg = ref.BurninConfig(**{**cfg.__dict__, "remat": "none"})
    params = jax.eval_shape(lambda: ref.init_params(
        rcfg, jax.random.PRNGKey(0)))
    tokens = jax.ShapeDtypeStruct((rcfg.batch, rcfg.seq), np.int32)
    lowered = jax.jit(lambda p, b: ref.train_step(p, b, rcfg)).lower(
        params, (tokens, tokens))
    cost = lowered.compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


@pytest.mark.parametrize("name", ["d256_s256", "d1024_s512"])
def test_flops_per_step_against_reference_cost_analysis(name):
    """XLA also counts elementwise work (softmax, norms, GELU, the SGD
    update) that the port's product count leaves out: measured 3.9% above
    at d256/s256 and 1.0% at d1024/s512, shrinking with width. The
    products themselves are the same, so the ratio lies in [1, 1.05]."""
    cfg = WIDTHS[name]
    ratio = _reference_cost_flops(cfg) / port.flops_per_step(cfg)
    assert 1.0 <= ratio <= 1.05, ratio


TINY = dict(vocab=64, d_model=32, d_ff=64, n_heads=2, seq=8, batch=4)


@pytest.fixture(scope="module")
def timed_pair():
    """Both packages' timed_steps at the same tiny width (the reference on
    one device, so its count is global as the port's), and what the port's
    fed the metrics windows."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    want = ref.timed_steps(mesh, ref.BurninConfig(**TINY), steps=2, reps=1)
    with runtime_metrics.duty_cycle_window() as duty, \
            runtime_metrics.tensorcore_window() as tc:
        got = port.timed_steps(port.BurninConfig(**TINY), steps=2, reps=1,
                               device="cpu")
    return got, want, duty, tc


def test_timed_steps_has_the_reference_keys(timed_pair):
    """The same keys, but for the estimator's outcome: a spread when some
    pair's delta cleared the noise floor, else a note (which one depends
    on the run's timings, at this size on either side)."""
    got, want, _, _ = timed_pair
    outcome = {"tflops_spread", "note"}
    assert set(got) - outcome == set(want) - outcome
    assert len(set(got) & outcome) == len(set(want) & outcome) == 1
    assert got["flops_scope"] == want["flops_scope"] == "global"
    assert got["estimator"] == want["estimator"]


def test_timed_steps_points_and_rates(timed_pair):
    got, _, _, _ = timed_pair
    assert [p["steps"] for p in got["points"]] == [2, 6]
    assert got["steps"] == 2 and got["reps"] == 1
    assert got["flops_per_step"] == _closed_form(port.BurninConfig(**TINY))
    assert got["tflops"] >= 0
    assert got["tokens_per_s"] > 0


def test_timed_steps_feeds_the_metrics_windows(timed_pair):
    """Each timed run (not the warm-up pair) reports its FLOPs after its
    sync and is one device-busy region."""
    got, _, duty, tc = timed_pair
    assert tc._total_flops == got["flops_per_step"] * (2 + 6) * got["reps"]
    # one pair: its two runs are the busy regions (points are rounded to
    # 1e-4 s; the regions and the timings differ by a clock read each)
    timed = sum(p["seconds"] for p in got["points"])
    assert duty.total_busy_s == pytest.approx(timed, rel=0.05, abs=2e-3)
