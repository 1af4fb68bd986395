"""The port's sharded bench arms (``workloads/shardbench.py``) against the
reference's ``tests/test_shardbench.py``, where it applies: the arm plan
at 1, 2, 4 and 8 devices against the reference's ``plan``, the full
long-context arm on the flash path on a card, the measured path on gloo
ranks with tiny arms, per-arm error isolation, ``timed_steps`` on a mesh,
and the CLI document."""

import json
from dataclasses import replace

import pytest

from tpu_cluster.workloads import shardbench as ref
from tpu_cluster_torch.workloads import burnin, collectives, shardbench


def _fields(cfg):
    return dict(cfg.__dict__)


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plan_matches_reference(n, tiny):
    """The same arms, meshes, steps, reps and configurations; the tiny
    geometry differs only in its heads (4 here, 2 there)."""
    got, want = shardbench.plan(n, tiny), ref.plan(n, tiny)
    assert [a.name for a in got] == [a.name for a in want] == \
        ["dp", "mp", "long_context"]
    for a, b in zip(got, want):
        assert (a.mesh_shape, a.steps, a.reps) == \
            (b.mesh_shape, b.steps, b.reps), a.name
        want_cfg = _fields(b.cfg)
        if tiny:
            want_cfg["n_heads"] = shardbench._TINY.n_heads
        assert _fields(a.cfg) == want_cfg, a.name
        assert a.cfg.batch % a.mesh_shape[0] == 0
        # every tiny split is whole on the model axis
        if tiny:
            tp = a.mesh_shape[1]
            assert a.cfg.n_heads % tp == a.cfg.d_ff % tp == \
                a.cfg.vocab % tp == 0


def test_tiny_deviates_from_reference_in_heads_only():
    assert replace(shardbench._TINY, n_heads=ref._TINY.n_heads).__dict__ \
        == ref._TINY.__dict__
    assert shardbench._TINY.n_heads % 4 == 0


def test_plan_full_long_context_arm_is_flash_eligible():
    arms = {a.name: a for a in shardbench.plan(8, tiny=False)}
    long = arms["long_context"].cfg
    assert long.seq >= burnin.FLASH_CROSSOVER_SEQ
    assert burnin.select_attention(long, "cuda") == "flash"
    assert burnin.select_attention(long, "cpu") == "xla"
    # at H / tp heads the kernels still see a head width they take
    tp = arms["long_context"].mesh_shape[1]
    assert long.n_heads % tp == 0


def test_plan_single_device_degenerates_cleanly():
    for arm in shardbench.plan(1, tiny=True):
        assert arm.mesh_shape == (1, 1)
        assert arm.cfg.batch == shardbench._TINY.batch


def _assert_arm(name, arm):
    assert "error" not in arm, (name, arm)
    assert arm["attention"] == "xla", name  # never flash on the CPU
    assert arm["tflops"] > 0 and arm["tokens_per_s"] > 0, name
    spread = arm.get("tflops_spread")
    if spread is not None:
        assert spread["min"] <= spread["median"] <= spread["max"]
        assert spread["n"] >= 1
    else:  # noise-floor fallback must say so, never silently
        assert "note" in arm, name
    assert arm["flops_scope"] == "global", name


def test_run_arms_on_four_gloo_ranks():
    doc = shardbench.run_arms(n_devices=4, device="cpu")
    assert doc["platform"] == "cpu" and doc["devices"] == 4 and doc["tiny"]
    assert set(doc["arms"]) == {"dp", "mp", "long_context"}
    for name, arm in doc["arms"].items():
        _assert_arm(name, arm)
    assert doc["arms"]["dp"]["mesh"] == {"data": 4, "model": 1}
    assert doc["arms"]["mp"]["mesh"] == {"data": 1, "model": 4}
    assert doc["arms"]["long_context"]["mesh"] == {"data": 1, "model": 4}
    # the global batch's FLOPs, whatever the mesh
    for arm in shardbench.plan(4, tiny=True):
        assert doc["arms"][arm.name]["flops_per_step"] == \
            burnin.flops_per_step(arm.cfg)


def test_run_arms_isolates_a_failing_arm(monkeypatch):
    real = shardbench.measure_arm

    def boom(arm, platform=None, device=None):
        if arm.name == "mp":
            raise RuntimeError("step failed")
        return real(arm, platform, device)

    monkeypatch.setattr(shardbench, "measure_arm", boom)
    doc = shardbench.run_arms(device="cpu")
    assert "error" in doc["arms"]["mp"]
    assert "RuntimeError" in doc["arms"]["mp"]["error"]
    assert doc["arms"]["mp"]["mesh"] == {"data": 1, "model": 1}
    for name in ("dp", "long_context"):
        _assert_arm(name, doc["arms"][name])


def test_run_arms_refuses_a_count_other_than_the_group():
    with collectives.process_group("cpu"):
        with pytest.raises(ValueError, match="requested 2 devices"):
            shardbench.run_arms(n_devices=2, device="cpu")


def test_timed_steps_on_a_mesh_has_reference_keys_and_global_scope():
    cfg = shardbench._TINY
    with collectives.process_group("cpu"):
        mesh = burnin.make_mesh((1, 1), "cpu")
        got = burnin.timed_steps(cfg, steps=2, reps=1, device="cpu",
                                 mesh=mesh)
    want_keys = {"steps", "seconds", "flops_per_step", "flops_scope",
                 "estimator", "reps", "points", "tflops", "tokens_per_s"}
    assert want_keys <= set(got) <= want_keys | {"tflops_spread", "note"}
    assert got["flops_scope"] == "global"
    assert got["flops_per_step"] == burnin.flops_per_step(cfg)


def test_cli_doc_is_json_serialisable():
    doc = json.loads(json.dumps(shardbench.main(["--device", "cpu"])))
    assert doc["check"] == "shardbench" and doc["devices"] == 1
    assert set(doc["arms"]) == {"dp", "mp", "long_context"}
    roof = doc["collectives"]
    assert roof["check"] == "ici_roofline" and roof["devices"] == 1
    # one rank moves nothing over a link
    for op in ("all_reduce", "all_gather"):
        assert roof[op]["busbw_gib_s"] == 0.0
    assert "link_util" not in roof  # no link rate on the CPU


def test_plan_full_arms_past_the_crossover_run_the_kernels_on_a_card():
    for arm in shardbench.plan(8, tiny=False):
        want = "flash" if arm.cfg.seq >= burnin.FLASH_CROSSOVER_SEQ else "xla"
        assert burnin.select_attention(arm.cfg, "cuda") == want
        assert burnin.select_attention(arm.cfg, "cpu") == "xla"
