"""The yardstick's arithmetic: the card's published peaks and the model
work of every quantity a metric divides by.

Every count here is the model's work, fixed by the shapes alone and the
same whatever implements it: a served token is counted as if keys and
values were cached, a training step with attention at full S^2, and the
LM head as one product a pass, however many products the program runs.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB, dense rates from NVIDIA's data sheet, at the full
# 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def matmul_flops_per_token(d: int, f: int, v: int) -> int:
    """The block's and the head's products for one token, forward:
    q, k, v, o (4 D^2), the FFN (2 D F) and the LM head (D V), two
    operations a multiply-add."""
    return 2 * (4 * d * d + 2 * d * f + d * v)


def served_token_flops(d: int, f: int, v: int, ctx: int) -> int:
    """Model work of one decoded token that attends over ``ctx``
    positions (itself included): the products of one token, plus its
    scores and its weighted sum over ``ctx`` cached keys and values
    (2 D ctx each)."""
    return matmul_flops_per_token(d, f, v) + 4 * d * ctx


def train_step_flops(batch: int, seq: int, d: int, f: int, v: int) -> int:
    """Model work of one training step: forward and backward (three
    times the forward) of the products and of causal attention at full
    S^2, ``3 * (2*B*S*(4D^2 + 2DF + DV) + 4*B*S^2*D)``. The SGD update's
    elementwise work is not counted."""
    return 3 * (batch * seq * matmul_flops_per_token(d, f, v)
                + 4 * batch * seq * seq * d)


def causal_product_flops(batch: int, heads: int, d_head: int,
                         seq: int) -> int:
    """W: one causal product over ``[B, S, H, D]`` operands, the S(S+1)/2
    pairs at or below the diagonal, two operations each, per head and
    batch row."""
    return batch * heads * d_head * seq * (seq + 1)


def attn_fwd_flops(batch: int, heads: int, d_head: int, seq: int) -> int:
    """Causal attention forward: scores and the weighted sum, 2W."""
    return 2 * causal_product_flops(batch, heads, d_head, seq)


def attn_bwd_flops(batch: int, heads: int, d_head: int, seq: int) -> int:
    """Causal attention backward: the recomputed scores (the forward keeps
    only the row log-sum-exp), dV, dP, dQ and dK, 5W."""
    return 5 * causal_product_flops(batch, heads, d_head, seq)


def attn_fwd_bytes(batch: int, heads: int, d_head: int, seq: int) -> int:
    """q, k, v read once and o written once in bf16, and the f32 row
    log-sum-exp written once."""
    return 4 * batch * seq * heads * d_head * 2 + batch * heads * seq * 4


def attn_bwd_bytes(batch: int, heads: int, d_head: int, seq: int) -> int:
    """q, k, v, dO read once and dQ, dK, dV written once in bf16; the f32
    log-sum-exp and rowsum(o * dO) read once."""
    return 7 * batch * seq * heads * d_head * 2 + 2 * batch * heads * seq * 4


def roofline_share(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the card could take (operations at the bf16 peak or
    bytes at the HBM peak, whichever is longer) over the time taken, in
    percent."""
    least = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
    return 100.0 * least / seconds
