"""What each gloo rank of ``tests/test_torch_sharded.py`` runs. It imports
torch and the port only (no JAX), so a spawned rank starts quickly;
``collectives.run_ranks`` returns rank 0's result."""

import numpy as np
import torch
import torch.distributed as dist

from tpu_cluster_torch.workloads import burnin, tensor_parallel

STEPS = 2


def _full(np_params, np_batch, device):
    params = burnin.params_from_jax(np_params, device)
    batch = tuple(torch.from_numpy(x).to(device) for x in np_batch)
    return params, batch


def gather_params(params, mesh):
    """The full parameters from every model-axis rank's shard: an
    all-gather over ``"model"`` (in f32) along each parameter's split
    dimension, what the reference's ``jax.device_get`` of a sharded array
    gives."""
    tp = mesh["model"].size()
    if tp == 1:
        return dict(params)
    out = {}
    for name, spec in burnin.param_specs().items():
        p = params[name].float().contiguous()
        parts = [torch.empty_like(p) for _ in range(tp)]
        dist.all_gather(parts, p, group=mesh["model"].get_group())
        out[name] = torch.cat(parts, dim=spec.index("model"))
    return out


def two_steps(mesh, cfg, params, batch):
    """Losses and gathered parameters after ``STEPS`` sharded steps from
    the full ``params`` and ``batch``: this rank's shard of each and its
    rows of the batch."""
    step, _, _ = burnin.make_sharded_step(mesh, cfg)
    p = burnin.shard_params(params, mesh.get_local_rank("model"),
                            mesh["model"].size())
    b = burnin.data_rows(batch, mesh)
    losses = []
    for _ in range(STEPS):
        p, loss = step(p, b)
        losses.append(float(loss))
    full = gather_params(p, mesh)
    return {"losses": losses,
            "params": {k: v.float().cpu().numpy() for k, v in full.items()}}


def _max_over_ranks(x: float) -> float:
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def vocab_parallel_errors(mesh, seed: int = 0):
    """The vocabulary-split cross-entropy and embedding on this mesh's
    model axis against their one-rank versions on the full tensors,
    forward and backward: the largest absolute error over every rank."""
    tp = mesh["model"].size()
    rank = mesh.get_local_rank("model")
    axis = tensor_parallel.ModelAxis(mesh["model"].get_group(), rank, tp)
    rng = np.random.default_rng(seed)
    vocab, rows = 16 * tp, 12
    logits = torch.from_numpy(
        (rng.standard_normal((3, rows, vocab)) * 4).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, vocab, (3, rows)))
    width = vocab // tp
    mine = logits[..., rank * width:(rank + 1) * width].clone()

    full = logits.clone().requires_grad_()
    want = burnin.softmax_xent(full, targets)
    (want_grad,) = torch.autograd.grad(want, full)
    mine.requires_grad_()
    got = tensor_parallel.vocab_parallel_xent(mine, targets, axis)
    (got_grad,) = torch.autograd.grad(got, mine)
    xent = abs(got.item() - want.item())
    xent_grad = (got_grad - want_grad[..., rank * width:(rank + 1) * width]
                 ).abs().max().item()

    table = torch.from_numpy(rng.standard_normal((vocab, 8)).astype(
        np.float32))
    cot = torch.from_numpy(rng.standard_normal((3, rows, 8)).astype(
        np.float32))
    whole = table.clone().requires_grad_()
    want_rows = whole[targets]
    (want_table_grad,) = torch.autograd.grad(want_rows, whole, cot)
    part = table[rank * width:(rank + 1) * width].clone().requires_grad_()
    got_rows = tensor_parallel.embed_lookup(part, targets, axis)
    (got_table_grad,) = torch.autograd.grad(got_rows, part, cot)
    embed = (got_rows - want_rows).abs().max().item()
    embed_grad = (got_table_grad - want_table_grad[
        rank * width:(rank + 1) * width]).abs().max().item()
    return {name: _max_over_ranks(err) for name, err in (
        ("xent", xent), ("xent_grad", xent_grad), ("embed", embed),
        ("embed_grad", embed_grad))}


def gathered_rows_error(mesh, cfg, params, batch, seed: int = 0):
    """The forward on this mesh's model axis with ``at`` (the block's tail
    and the LM head on one row a batch row) against the same forward's
    full logits gathered at those rows: the largest absolute error over
    every rank, and the largest logit."""
    tp = mesh["model"].size()
    axis = tensor_parallel.ModelAxis(mesh["model"].get_group(),
                                     mesh.get_local_rank("model"), tp)
    p = burnin.shard_params(params, axis.rank, tp)
    toks = burnin.data_rows(batch, mesh)[0]
    at = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.seq, toks.shape[0]))
    with torch.no_grad():
        full = burnin.forward(p, toks, cfg, axis)
        rows = burnin.forward(p, toks, cfg, axis, at=at)
    want = full[torch.arange(toks.shape[0]), at]
    return {"err": _max_over_ranks((rows - want).abs().max().item()),
            "shape": tuple(rows.shape),
            "logit": _max_over_ranks(want.abs().max().item())}


def cases(np_params, np_batch, cfg_fields, shapes, ragged, remats=(),
          device=None):
    """Every case of one world size: the sharded steps at each mesh of
    ``shapes``, then at each ``(shape, remat)`` of ``remats`` with that
    remat policy, the vocabulary-split pieces on the last mesh of
    ``shapes``, and the error a ragged split over that mesh's model axis
    raises for each config override in ``ragged``; the forward's gathered
    tail (``at``) on that mesh."""
    cfg = burnin.BurninConfig(**cfg_fields)
    params, batch = _full(np_params, np_batch, device)
    out = {"steps": {}, "remat": {}, "ragged": {}}
    for shape, remat in remats:
        out["remat"][shape, remat] = two_steps(
            burnin.make_mesh(shape, device),
            burnin.BurninConfig(**{**cfg_fields, "remat": remat}), params,
            batch)
    mesh = None
    for shape in shapes:
        mesh = burnin.make_mesh(shape, device)
        out["steps"][shape] = two_steps(mesh, cfg, params, batch)
    out["vocab_parallel"] = vocab_parallel_errors(mesh)
    out["gathered_rows"] = gathered_rows_error(mesh, cfg, params, batch)
    for name, fields in ragged.items():
        try:
            burnin.make_sharded_step(
                mesh, burnin.BurninConfig(**{**cfg_fields, **fields}))
        except ValueError as err:
            out["ragged"][name] = str(err)
    try:
        burnin.make_mesh((1, 1), device)
    except ValueError as err:
        out["ragged"]["small_mesh"] = str(err)
    return out
