"""The model work of the sparse cells: what their metrics divide by.

As in ``work``: every count is the model's work, fixed by the shapes
alone. Attention counts the (query, key) pairs each layer's mask admits,
a sliding layer's window and a full layer's causal triangle; the experts
count the routed (token, expert) pairs, ``top_k`` a token, however they
fall on the experts; the LM head one product a pass. Training is three
times the forward (the forward, and the backward's two products a
product); the SGD update is not counted.
"""

from __future__ import annotations

from typing import Any, Dict


def admitted_pairs(seq: int, window: int) -> int:
    """(query, key) pairs of one ``[seq]`` row that the mask admits: key
    j for query i iff ``0 <= i - j < window``, or ``j <= i`` where
    ``window`` is 0."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def layer_windows(model: Dict[str, Any]):
    """Each layer's window (0: causal)."""
    return [model["window"] if kind == "sliding" else 0
            for kind in model["layer_types"]]


def attn_product_flops(batch: int, seq: int, model: Dict[str, Any]) -> int:
    """W summed over the layers: one product over each layer's admitted
    pairs, ``2 * B * H * d_head * pairs`` (the query heads: each reads
    its key head's keys)."""
    return sum(2 * batch * model["n_heads"] * model["d_head"]
               * admitted_pairs(seq, w) for w in layer_windows(model))


def attn_fwd_flops(batch: int, seq: int, model: Dict[str, Any]) -> int:
    """Attention forward, every layer: scores and the weighted sum, 2W."""
    return 2 * attn_product_flops(batch, seq, model)


def attn_bwd_flops(batch: int, seq: int, model: Dict[str, Any]) -> int:
    """Attention backward, every layer: the recomputed scores, dV, dP, dQ
    and dK, 5W."""
    return 5 * attn_product_flops(batch, seq, model)


def _qkvo(batch: int, seq: int, model: Dict[str, Any]) -> int:
    """Elements of one ``[B, S, H, d_head]`` tensor of the kernels."""
    return batch * seq * model["n_heads"] * model["d_head"]


def attn_fwd_bytes(batch: int, seq: int, model: Dict[str, Any]) -> int:
    """q, k, v read and o written once in bf16, and the f32 row
    log-sum-exp written once, every layer (k and v as the kernels read
    them, repeated to the query heads)."""
    rows = batch * model["n_heads"] * seq
    return model["layers"] * (4 * _qkvo(batch, seq, model) * 2 + rows * 4)


def attn_bwd_bytes(batch: int, seq: int, model: Dict[str, Any]) -> int:
    """q, k, v, dO read and dQ, dK, dV written once in bf16; the f32
    log-sum-exp and rowsum(o * dO) read once; every layer."""
    rows = batch * model["n_heads"] * seq
    return model["layers"] * (7 * _qkvo(batch, seq, model) * 2 + rows * 8)


def expert_flops_per_token(model: Dict[str, Any]) -> int:
    """The expert products of one token's forward, every layer: ``top_k``
    experts, each W1, W3 (D x F) and W2 (F x D)."""
    return (model["layers"] * model["top_k"] * 3 * 2 * model["d_model"]
            * model["d_expert"])


def matmul_flops_per_token(model: Dict[str, Any]) -> int:
    """Every product of one token's forward but attention's scores and
    weighted sum: per layer q, k, v, o, the router and the experts; and
    the LM head."""
    d, hd = model["d_model"], model["d_head"]
    proj = 2 * d * hd * (2 * model["n_heads"] + 2 * model["n_kv_heads"])
    router = 2 * d * model["n_experts"]
    return (model["layers"] * (proj + router) + expert_flops_per_token(model)
            + 2 * d * model["vocab"])


def train_step_flops(batch: int, seq: int, model: Dict[str, Any]) -> int:
    """Model work of one training step: three times the forward's
    products and its attention over the admitted pairs."""
    return 3 * (batch * seq * matmul_flops_per_token(model)
                + attn_fwd_flops(batch, seq, model))


def expert_train_flops(batch: int, seq: int, model: Dict[str, Any]) -> int:
    """The expert products of one training step: three times the
    forward's."""
    return 3 * batch * seq * expert_flops_per_token(model)
