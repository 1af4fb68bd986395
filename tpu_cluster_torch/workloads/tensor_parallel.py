"""Megatron-style tensor parallelism for the burn-in block, written out as
collectives: the port's counterpart of the layout the reference hands to
GSPMD through ``burnin.param_specs`` (``tpu_cluster/workloads/burnin.py``,
``P(None, "model")`` and friends), which torch has no partitioner for.

One rank a device, on a ``("data", "model")`` device mesh. Over the
``"model"`` axis of size ``tp`` a rank holds:

- ``wq``, ``wk``, ``wv``, ``w1`` split by columns: ``H / tp`` attention
  heads and ``F / tp`` hidden units of its own, so the flash kernels run
  unchanged at ``[B, S, H / tp, D]``;
- ``wo``, ``w2`` split by rows: each rank's product is a partial sum,
  completed by an all-reduce;
- ``embed`` split by vocabulary rows: a masked gather, then an
  all-reduce (one rank contributes each token's row);
- ``out`` split by vocabulary columns: each rank computes its slice of
  the logits, and the cross-entropy over the split vocabulary all-reduces
  the row max, the sum of exponentials and the gold logit
  (:func:`vocab_parallel_xent`).

The two conjugate autograd Functions are Megatron's: :func:`copy_to_model`
(``f``: identity forward, all-reduce backward) where a replicated
activation enters a column-split product, and :func:`reduce_from_model`
(``g``: all-reduce forward, identity backward) after a row-split product.
Every all-reduce runs in f32 and casts back to the input's dtype: a bf16
partial sum is then rounded once, after the sum.

A model axis of ``None`` is one rank: every function here is then the
single-device operation, so mesh (1, 1) computes what ``train_step`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the ``"model"`` axis: the axis's process
    group, the rank's index on it and the axis's size (> 1)."""

    group: Any
    rank: int
    size: int


def _all_reduce_f32(x: torch.Tensor, group: Any,
                    op: Any = dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` in f32, in ``x``'s
    dtype."""
    out = x.float().clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):  # type: ignore[override]
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):  # type: ignore[override]
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        return g, None


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """A replicated activation entering column-split products: its
    gradient is the sum of every rank's."""
    return x if axis is None else _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor,
                      axis: Optional[ModelAxis]) -> torch.Tensor:
    """The partial sums of a row-split product, completed over the
    axis."""
    return x if axis is None else _ReduceFromModel.apply(x, axis.group)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 axis: Optional[ModelAxis]) -> torch.Tensor:
    """Rows of a vocabulary-split embedding: each rank gathers the tokens
    that fall in its slice of the vocabulary (zeros for the rest), and
    the all-reduce assembles every token's row, exactly (one non-zero
    term each). In the embedding's dtype."""
    tokens = tokens.long()
    if axis is None:
        return embed[tokens]
    rows = embed.shape[0]
    local = tokens - axis.rank * rows
    inside = (local >= 0) & (local < rows)
    part = embed[local.clamp(0, rows - 1)]
    part = torch.where(inside[..., None], part, torch.zeros_like(part))
    return reduce_from_model(part, axis)


class _VocabParallelXent(torch.autograd.Function):
    """Mean token cross-entropy over vocabulary-split logits: the forward
    and the fused closed-form backward of ``burnin._SoftmaxXent``, with
    the row max (MAX), the sum of exponentials and the gold logit (SUM)
    all-reduced over the model axis. The backward needs no collective:
    each rank's slice of (softmax - onehot) * g / N is its own."""

    @staticmethod
    def forward(ctx, logits, targets, group, vocab_start):  # type: ignore[override]
        width = logits.shape[-1]
        row_max = logits.amax(-1)
        dist.all_reduce(row_max, op=dist.ReduceOp.MAX, group=group)
        sum_exp = torch.exp(logits - row_max[..., None]).sum(-1)
        dist.all_reduce(sum_exp, group=group)
        lse = row_max + torch.log(sum_exp)
        local = targets.long() - vocab_start
        inside = (local >= 0) & (local < width)
        local = local.clamp(0, width - 1)
        gold = logits.gather(-1, local[..., None])[..., 0]
        gold = torch.where(inside, gold, torch.zeros_like(gold))
        dist.all_reduce(gold, group=group)
        ctx.save_for_backward(logits, local, inside, lse)
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        logits, local, inside, lse = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, local[..., None],
                       -inside[..., None].to(d.dtype))
        return d.mul_(g / math.prod(logits.shape[:-1])), None, None, None


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        axis: ModelAxis) -> torch.Tensor:
    """Mean cross-entropy of this rank's ``[..., V / tp]`` slice of the
    logits (vocabulary ``rank * V / tp`` onwards) against global target
    ids; the same value on every rank of the axis."""
    return _VocabParallelXent.apply(logits, targets, axis.group,
                                    axis.rank * logits.shape[-1])
