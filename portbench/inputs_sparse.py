"""The inputs of the sparse cells, made from ``--seed`` and handed to both
the program and the plain reference: training parameters and token ids
drawn from a Zipf law. Also the shape of model that the program's sparse
decoder and its attention kernels run (:func:`check_sparse`)."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from portbench.inputs import _generator

# The layer kinds of a configuration's ``layer_types``.
KINDS = ("sliding", "full")


def check_sparse(model: Dict[str, Any]) -> None:
    """Raise where the sparse decoder cannot run ``model``: query heads a
    whole multiple of the key heads, at a width the attention kernels
    take, no more experts a token than there are, and whole periods of
    ``layer_types``."""
    from tpu_cluster_torch.kernels.flash_attention import SUPPORTED_HEAD_DIMS

    if model["n_heads"] % model["n_kv_heads"]:
        raise ValueError(f"n_heads {model['n_heads']} is no multiple of "
                         f"n_kv_heads {model['n_kv_heads']}")
    if model["d_head"] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"d_head {model['d_head']} is none of the kernels' "
                         f"{SUPPORTED_HEAD_DIMS}")
    if not 1 <= model["top_k"] <= model["n_experts"]:
        raise ValueError(f"top_k {model['top_k']} not in 1.."
                         f"{model['n_experts']}")
    types = model["layer_types"]
    period = len(model["period"])
    if set(types) - set(KINDS) or model["layers"] != len(types) \
            or len(types) % period or types != model["period"] * (
                len(types) // period):
        raise ValueError(f"layer_types {types} are not whole periods of "
                         f"{model['period']} ({model['layers']} layers)")


def param_shapes(model: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...],
                                                           float]]:
    """Each parameter's shape and init scale (0: a norm's weight, ones),
    in the program's ``[in, out]`` layout and names. The embedding's rows
    at unit RMS: at 0.02, what random attention averages over a long
    context outweighs each token's own state, and every token takes the
    same experts."""
    d, hd = model["d_model"], model["d_head"]
    q, kv = model["n_heads"] * hd, model["n_kv_heads"] * hd
    e, f, v = model["n_experts"], model["d_expert"], model["vocab"]
    out = {"embed": ((v, d), 1.0)}
    for i in range(model["layers"]):
        out.update({
            f"layers.{i}.attn_norm": ((d,), 0.0),
            f"layers.{i}.wq": ((d, q), d ** -0.5),
            f"layers.{i}.wk": ((d, kv), d ** -0.5),
            f"layers.{i}.wv": ((d, kv), d ** -0.5),
            f"layers.{i}.wo": ((q, d), q ** -0.5),
            f"layers.{i}.mlp_norm": ((d,), 0.0),
            f"layers.{i}.router": ((d, e), d ** -0.5),
            f"layers.{i}.w1": ((e, d, f), d ** -0.5),
            f"layers.{i}.w3": ((e, d, f), d ** -0.5),
            f"layers.{i}.w2": ((e, f, d), f ** -0.5),
        })
    out["final_norm"] = ((d,), 0.0)
    out["out"] = ((d, v), d ** -0.5)
    return out


def train_params(model: Dict[str, Any], seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """f32 master parameters from ``seed``: one normal draw for all of
    them, each scaled in place; the norms' weights are ones. The tensors
    are views of one buffer."""
    shapes = param_shapes(model)
    sizes = [torch.Size(s).numel() for s, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=_generator(seed, device),
                       device=device, dtype=torch.float32)
    out = {}
    for (name, (shape, scale)), part in zip(shapes.items(),
                                            flat.split(sizes)):
        out[name] = (part.view(shape).mul_(scale) if scale
                     else part.view(shape).fill_(1.0))
    return out


def zipf_batches(vocab: int, batch: int, seq: int, count: int,
                 exponent: float, base_seed: int, seed: int,
                 device: torch.device
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``count`` batches of ids drawn from a Zipf law of ``exponent`` over
    the vocabulary: rank r (from 1) has probability proportional to
    ``r^-exponent``, and the id of each rank is a fixed permutation from
    ``base_seed``; the draws come from ``seed`` (a stream of its own,
    apart from the parameters'). Each row ``seq + 1`` ids: tokens the
    first ``seq``, targets the ids shifted by one."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = ranks.pow(-exponent).cumsum(0)
    cdf /= cdf[-1].clone()
    ids_of_rank = torch.randperm(vocab, generator=_generator(base_seed,
                                                             device),
                                 device=device)
    u = torch.rand((count, batch, seq + 1), generator=_generator(
        int(seed) ^ 0x5EED0F1D5, device), device=device, dtype=torch.float64)
    rank = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    ids = ids_of_rank[rank]
    return [(ids[i, :, :-1].contiguous(), ids[i, :, 1:].contiguous())
            for i in range(count)]
