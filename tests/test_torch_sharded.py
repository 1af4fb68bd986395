"""The port's sharded train step (``burnin.make_mesh``,
``make_sharded_step``, the Megatron pieces of
``workloads/tensor_parallel.py``) against the reference's
``make_sharded_step`` on the 8-device virtual CPU mesh of
``tests/conftest.py``.

The port runs one gloo rank a device: 2, 4 and 8 ranks, each world size
spawned once (``collectives.run_ranks``) for all of its meshes: (n, 1),
(1, n) and ``default_mesh_shape(n)``, and remat "dots" and "full" at
(1, 4) and (2, 2). Both packages start from the
reference's own initial parameters and batch (its ``_global_init``,
fetched whole and handed to the port through ``params_from_jax``); after
two steps the losses and the updated parameters, the port's gathered
from its shards, must agree within the tolerances of
``tests/test_torch_train.py``. Mesh (1, 1) must compute what
``train_step`` does.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_train import GRAD_MAX_REL, GRAD_MEAN_REL, LOSS_ATOL
import torch_sharded_ranks as ranks
from tpu_cluster.workloads import burnin as ref
from tpu_cluster_torch.workloads import burnin, collectives

# Heads, d_ff and vocab divide by every model axis up to 8.
CFG = dict(vocab=128, d_model=64, d_ff=256, n_heads=8, seq=16, batch=8)
WORLDS = (2, 4, 8)
# Config overrides that cannot split over a model axis of 2, 4 or 8.
RAGGED = {"n_heads": dict(n_heads=1, d_model=64),
          "d_ff": dict(d_ff=257), "vocab": dict(vocab=129)}


# Remat policies on a model axis, at 4 ranks: the checkpointed forward
# re-runs the model axis's collectives in the backward.
REMAT_WORLD = 4
REMATS = [(shape, remat) for shape in ((1, 4), (2, 2))
          for remat in ("dots", "full")]


def _shapes(n):
    """The meshes of world size ``n``, the one with the longest model axis
    last."""
    shapes = [(n, 1), ref.default_mesh_shape(n), (1, n)]
    return list(dict.fromkeys(shapes))


def _numpy(tree):
    # copies: the reference donates its parameter buffers to the step
    return jax.tree.map(lambda x: np.array(x), jax.device_get(tree))


@pytest.fixture(scope="module")
def reference():
    """Per mesh shape and remat policy (memoised): the reference's initial
    parameters and batch, its losses over two sharded steps, its
    parameters after them, and the gradients at the start (for the
    tolerances)."""
    cache = {}

    def get(shape, remat="none"):
        if (shape, remat) not in cache:
            cfg = ref.BurninConfig(**CFG, remat=remat)
            step, params, batch = ref.make_sharded_step(ref.make_mesh(shape),
                                                        cfg)
            start, start_batch = _numpy(params), _numpy(batch)
            losses = []
            for _ in range(ranks.STEPS):
                params, loss = step(params, batch)
                losses.append(float(loss))
            grads = jax.grad(ref.loss_fn)(
                jax.tree.map(np.asarray, start), start_batch, cfg)
            cache[shape, remat] = {"start": start, "batch": start_batch,
                                   "losses": losses, "params": _numpy(params),
                                   "grads": _numpy(grads)}
        return cache[shape, remat]
    return get


@pytest.fixture(scope="module")
def port(reference):
    """Per world size (memoised): every case of that size, all in one
    spawn of its ranks."""
    cache = {}

    def get(n):
        if n not in cache:
            want = reference((1, 1))
            cache[n] = collectives.run_ranks(
                n, ranks.cases, want["start"], want["batch"], CFG,
                _shapes(n), RAGGED, REMATS if n == REMAT_WORLD else (),
                device="cpu")
        return cache[n]
    return get


def _assert_matches(got, want):
    for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert abs(a - b) < LOSS_ATOL, (i, got["losses"], want["losses"])
    assert set(got["params"]) == set(want["params"])
    for name, p in got["params"].items():
        w = want["params"][name].astype(np.float32)
        g = np.abs(want["grads"][name].astype(np.float32))
        err = np.abs(p - w)
        # each step's update differs by lr times the gradient difference
        lr = CFG.get("lr", ref.BurninConfig().lr)
        assert err.max() <= ranks.STEPS * lr * GRAD_MAX_REL * g.max(), \
            (name, err.max(), g.max())
        assert err.mean() <= ranks.STEPS * lr * GRAD_MEAN_REL * g.mean(), \
            (name, err.mean(), g.mean())


MESHES = [(n, kind) for n in WORLDS for kind in ("dp", "tp", "default")]


@pytest.mark.parametrize("n,kind", MESHES,
                         ids=[f"n{n}-{kind}" for n, kind in MESHES])
def test_sharded_step_matches_reference(n, kind, reference, port):
    shape = {"dp": (n, 1), "tp": (1, n),
             "default": ref.default_mesh_shape(n)}[kind]
    want = reference(shape)
    # every mesh starts from the same numbers in the reference
    for name, p in reference((1, 1))["start"].items():
        np.testing.assert_array_equal(p, want["start"][name])
    _assert_matches(port(n)["steps"][shape], want)


@pytest.mark.parametrize("shape,remat", REMATS,
                         ids=[f"{s[0]}x{s[1]}-{r}" for s, r in REMATS])
def test_sharded_step_with_remat_matches_reference(shape, remat, reference,
                                                   port):
    """remat "dots" and "full" on a model axis: the backward recomputes the
    forward's all-reduces, in the same order on every rank; the result is
    the reference's with the same policy."""
    want = reference(shape, remat)
    for name, p in reference((1, 1))["start"].items():
        np.testing.assert_array_equal(p, want["start"][name])
    _assert_matches(port(REMAT_WORLD)["remat"][shape, remat], want)


def _one_rank_sharded(cfg, params, batch):
    with collectives.process_group("cpu"):
        mesh = burnin.make_mesh((1, 1), "cpu")
        return ranks.two_steps(mesh, cfg, params, batch)


def test_mesh_1x1_is_train_step(reference):
    """At mesh (1, 1) no collective runs: the same numbers as two
    ``train_step`` calls, and the reference's within tolerance."""
    want = reference((1, 1))
    cfg = burnin.BurninConfig(**CFG)
    params, batch = ranks._full(want["start"], want["batch"], "cpu")
    got = _one_rank_sharded(cfg, params, batch)
    p, losses = params, []
    for _ in range(ranks.STEPS):
        p, loss = burnin.train_step(p, batch, cfg)
        losses.append(float(loss))
    assert got["losses"] == losses
    for name, w in p.items():
        np.testing.assert_array_equal(got["params"][name], w.numpy())
    _assert_matches(got, want)


@pytest.mark.parametrize("n", WORLDS)
def test_vocab_parallel_xent_and_embedding_equal_one_rank(n, port):
    """Forward and backward over the model axis of (1, n) against the
    one-rank cross-entropy and gather on the full tensors: only f32
    summation order differs in the cross-entropy; the embedding is
    exact."""
    errs = port(n)["vocab_parallel"]
    assert errs["xent"] <= 1e-5 and errs["xent_grad"] <= 1e-7, errs
    assert errs["embed"] == 0.0 and errs["embed_grad"] == 0.0, errs


@pytest.mark.parametrize("name", sorted(RAGGED))
def test_ragged_split_names_the_axis(name, port):
    msg = port(2)["ragged"][name]
    assert f"{name}=" in msg and "'model' axis of size 2" in msg, msg


def test_mesh_must_span_the_group(port):
    msg = port(2)["ragged"]["small_mesh"]
    assert "covers 1 of the process group's 2 ranks" in msg


def test_make_mesh_error_names_the_offending_axis():
    with collectives.process_group("cpu"):
        with pytest.raises(ValueError, match="'data'"):
            burnin.make_mesh((64, 1), "cpu")
        with pytest.raises(ValueError, match="'model'"):
            burnin.make_mesh((1, 64), "cpu")
        with pytest.raises(ValueError, match="needs 64 devices, have 1"):
            burnin.make_mesh((16, 4), "cpu")


def test_param_specs_match_reference():
    want = ref.param_specs()
    got = burnin.param_specs()
    assert list(got) == list(want)
    for name, spec in want.items():
        assert got[name] == tuple(spec), name


@pytest.mark.parametrize("n", range(1, 17))
def test_default_mesh_shape_matches_reference(n):
    assert burnin.default_mesh_shape(n) == ref.default_mesh_shape(n)


def test_shard_then_gather_round_trips():
    cfg = burnin.BurninConfig(**CFG)
    params = burnin.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for tp in (1, 2, 4):
        shards = [burnin.shard_params(params, r, tp) for r in range(tp)]
        for name, spec in burnin.param_specs().items():
            dim = spec.index("model")
            assert shards[0][name].shape[dim] == params[name].shape[dim] // tp
            torch.testing.assert_close(
                torch.cat([s[name] for s in shards], dim), params[name],
                rtol=0, atol=0)
