"""The port's training path against the JAX reference: the fused
cross-entropy, loss and per-parameter gradients, parameters after two SGD
steps on every attention path and both parameter dtypes, the remat
policies and ``run`` on the CPU.

The reference's flash path runs upstream's TPU kernels (K1 with
residuals, K2, K3) in Pallas TPU interpret mode on the CPU, always under
``jax.jit`` (un-jitted, one step takes minutes). The port's flash path runs
its kernels' plain versions on the CPU, so these hold the port's whole
flash-path training step against the reference's own kernels.

Parameters come from the reference's ``init_params`` and cross through
numpy (``params_from_jax``); tokens are drawn with numpy from a seed.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_cluster.workloads import burnin as ref
from tpu_cluster_torch.workloads import burnin as port

# d_head 128 and seq 256: upstream's default flash blocks are 128, the
# port's kernels take d_head 128 and seq a multiple of 64.
TRAIN = dict(vocab=256, d_model=256, d_ff=512, n_heads=2, seq=256, batch=2,
             attn_block=64)

# Loss of the two packages: bf16 activations rounded at different places
# (fused elementwise passes, GEMM reduction order, bf16 P) move logits by
# up to ~1e-2 (tests/test_torch_burnin.py bounds them at 5e-2); averaged
# over B*S tokens the cross-entropy moves far less.
LOSS_ATOL = 2e-3
# Per-parameter gradients, relative to the reference's magnitude (the
# gradients of different parameters differ in scale by orders): the two
# packages round activations and their cotangents to bf16 at different
# places (2^-8 = 3.9e-3 relative each), and an element collects a few
# such roundings, so the bulk differs by ~1e-2 (mean |err| / mean |ref|;
# 3.5e-3 to 8.6e-3 at these widths) and the worst element by a few times
# that (max |err| / max |ref|; up to 1.4e-2 measured).
GRAD_MAX_REL = 5e-2
GRAD_MEAN_REL = 2e-2
# Parameters after two steps: each step's update lr * g differs between
# the packages by lr times the gradient difference (bounded above by
# GRAD_MAX_REL * max|g|). A bf16 parameter also rounds each update: lr * g
# is often near half a bf16 ulp of p (embedding rows: p ~ 1e-2, lr * g ~
# 3e-5), so a step may round the other way in the two packages, one ulp
# a step.
STEPS = 2


def _bf16_ulp(x):
    """The spacing of bf16 numbers (8 significant bits) at |x|."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _to_port(cfg):
    return port.BurninConfig(**cfg.__dict__)


def _setup(param_dtype, attention, seed=0):
    cfg = ref.BurninConfig(**TRAIN, param_dtype=param_dtype,
                           attention=attention)
    params = ref.init_params(cfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (cfg.batch, cfg.seq)).astype(np.int32)
    return cfg, params, (tokens, np.roll(tokens, -1, axis=1))


def _ref_two_steps(cfg, params, batch):
    """The reference's loss and gradients at ``params``, then the loss
    and parameters after two ``train_step``s, in one jitted call (under
    interpret mode when the flash path reaches upstream's kernels)."""
    def two_steps(p, b):
        loss, grads = jax.value_and_grad(ref.loss_fn)(p, b, cfg)
        p1, _ = ref.train_step(p, b, cfg)
        p2, loss1 = ref.train_step(p1, b, cfg)
        return loss, grads, loss1, p2

    jb = tuple(jnp.asarray(x) for x in batch)
    if cfg.attention == "flash":
        with pltpu.force_tpu_interpret_mode():
            out = jax.jit(two_steps)(params, jb)
    else:
        out = jax.jit(two_steps)(params, jb)
    return jax.tree.map(np.asarray, out)


def _port_two_steps(cfg, params, batch):
    tparams = port.params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, "cpu")
    tb = tuple(torch.from_numpy(x) for x in batch)
    pcfg = _to_port(cfg)
    loss, grads = port.loss_and_grads(tparams, tb, pcfg)
    p1, _ = port.train_step(tparams, tb, pcfg)
    p2, loss1 = port.train_step(p1, tb, pcfg)
    return loss, grads, loss1, p2


def _assert_grads_close(grads, want):
    assert set(grads) == set(want)  # jax returns the dict sorted
    for name, g in grads.items():
        w = want[name].astype(np.float32)
        got = g.float().numpy()
        assert got.shape == w.shape, name
        err = np.abs(got - w)
        assert err.max() <= GRAD_MAX_REL * np.abs(w).max(), \
            (name, err.max(), np.abs(w).max())
        assert err.mean() <= GRAD_MEAN_REL * np.abs(w).mean(), \
            (name, err.mean(), np.abs(w).mean())


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attention", ["flash", "xla", "chunked"])
def test_train_step_matches_reference(attention, param_dtype):
    cfg, params, batch = _setup(param_dtype, attention)
    want_loss, want_grads, want_loss1, want_p2 = _ref_two_steps(
        cfg, params, batch)
    loss, grads, loss1, p2 = _port_two_steps(cfg, params, batch)

    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - float(want_loss)) < LOSS_ATOL
    assert abs(loss1.item() - float(want_loss1)) < LOSS_ATOL
    _assert_grads_close(grads, want_grads)
    want_dtype = torch.bfloat16 if param_dtype == "bf16" else torch.float32
    for name, p in p2.items():
        assert p.dtype == want_dtype, name
        got, want = p.float().numpy(), want_p2[name].astype(np.float32)
        g_max = np.abs(want_grads[name].astype(np.float32)).max()
        bound = STEPS * cfg.lr * GRAD_MAX_REL * g_max
        if param_dtype == "bf16":
            bound = bound + STEPS * _bf16_ulp(np.maximum(np.abs(got),
                                                         np.abs(want)))
        assert (np.abs(got - want) <= bound).all(), \
            (name, np.abs(got - want).max())


@pytest.mark.parametrize("shape", [(2, 16, 64), (3, 5, 256)])
def test_softmax_xent_matches_reference(shape):
    """f32 logits, one formula in both packages (logsumexp - gold forward,
    (softmax - onehot) g / N backward): only f32 rounding differs."""
    rng = np.random.default_rng(sum(shape))
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    targets = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want, want_grad = jax.value_and_grad(ref.softmax_xent)(
        jnp.asarray(logits), jnp.asarray(targets))
    tl = torch.from_numpy(logits).requires_grad_()
    got = port.softmax_xent(tl, torch.from_numpy(targets))
    (grad,) = torch.autograd.grad(got, tl)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-8)


def test_softmax_xent_backward_scales_with_the_cotangent():
    logits = torch.randn(4, 8, generator=torch.Generator().manual_seed(0),
                         requires_grad=True)
    targets = torch.arange(4)
    (g1,) = torch.autograd.grad(port.softmax_xent(logits, targets), logits)
    (g3,) = torch.autograd.grad(3.0 * port.softmax_xent(logits, targets),
                                logits)
    torch.testing.assert_close(g3, 3.0 * g1)
    # each row of (softmax - onehot) sums to zero
    torch.testing.assert_close(g1.sum(-1), torch.zeros(4), atol=1e-7,
                               rtol=0)


# Recomputation changes what is saved for the backward, never the result
# (the reference pins the same in tests/test_workloads.py).
REMATS = {"xla": ("none", "attn", "dots", "full"),
          "chunked": ("none", "dots", "full"),
          "flash": ("none", "dots", "full")}


@pytest.mark.parametrize("attention", sorted(REMATS))
def test_remat_policies_train_identically(attention):
    cfg = port.BurninConfig(**TRAIN, attention=attention)
    params = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (cfg.batch, cfg.seq)))
    batch = (tokens, torch.roll(tokens, -1, dims=1))
    runs = {}
    for remat in REMATS[attention]:
        p, losses = params, []
        for _ in range(2):
            p, loss = port.train_step(p, batch, replace(cfg, remat=remat))
            losses.append(loss.item())
        runs[remat] = (losses, p)
    base_losses, base_params = runs["none"]
    for remat, (losses, p) in runs.items():
        assert all(abs(a - b) < 1e-4 for a, b in zip(losses, base_losses)), \
            (remat, losses, base_losses)
        for name in p:
            torch.testing.assert_close(p[name], base_params[name], rtol=0,
                                       atol=1e-6)


def test_remat_attn_rejected_off_the_xla_path_like_reference():
    for attention in ("flash", "chunked"):
        cfg = ref.BurninConfig(**TRAIN, attention=attention, remat="attn")
        params = ref.init_params(cfg, jax.random.PRNGKey(0))
        tokens = np.zeros((cfg.batch, cfg.seq), np.int32)
        with pytest.raises(ValueError) as want:
            ref.loss_fn(params, (jnp.asarray(tokens),) * 2, cfg)
        tparams = port.params_from_jax(
            {k: np.asarray(v) for k, v in params.items()}, "cpu")
        with pytest.raises(ValueError) as got:
            port.train_step(tparams, (torch.from_numpy(tokens),) * 2,
                            _to_port(cfg))
        assert str(got.value) == str(want.value)


def test_train_step_leaves_its_input_parameters_alone():
    cfg = port.BurninConfig(**TRAIN)
    params = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = {k: v.clone() for k, v in params.items()}
    tokens = torch.zeros((cfg.batch, cfg.seq), dtype=torch.long)
    new, _ = port.train_step(params, (tokens, tokens), cfg)
    for name in params:
        assert torch.equal(params[name], before[name])
        assert not new[name].requires_grad
        assert not torch.equal(new[name], params[name]), name


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_run_on_cpu_decreases_loss_with_reference_keys(attention):
    cfg = port.BurninConfig(**TRAIN, attention=attention)
    got = port.run(steps=3, cfg=cfg, device="cpu")
    want_keys = {"check", "mesh", "devices", "processes", "steps",
                 "losses", "seconds", "loss_decreasing", "ok"}
    assert set(got) == want_keys
    assert got["check"] == "burnin"
    assert got["mesh"] == {"data": 1, "model": 1}
    assert got["devices"] == 1 and got["processes"] == 1
    assert got["steps"] == 3 and len(got["losses"]) == 3
    assert all(np.isfinite(got["losses"]))
    assert got["loss_decreasing"] and got["ok"], got
    assert got["seconds"] > 0
