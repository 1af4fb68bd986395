"""The plain reference of the sparse decoder (Mellum2-12B-A2.5B's layer
equations): plain PyTorch in float32, TF32 off (``model.pin_precision``),
with no kernel, grouping or fusion.

Per layer ``i`` of ``model["layer_types"]``, from ``x = embed[tokens]``::

    y = norm_i(x) ; q = y Wq ; k = y Wk ; v = y Wv    (heads of d_head)
    q, k rotated: x cos + rotate_half(x) sin
    k, v repeated: query head h reads key head h // (H / KV)
    x = x + Wo softmax(q k^T / sqrt(d_head) + mask) v
    x = x + sum over the top_k experts e of w_e W2_e (silu(W1_e y) * W3_e y),
        y = norm'_i(x), w = softmax(y Wr) at its top_k, renormalised

then ``logits = norm(x) Wout``; loss the mean token cross-entropy;
training plain SGD, ``p - lr * g``. ``norm`` is x / sqrt(mean(x^2) + eps)
times its weight. The mask lets query i see key j iff ``0 <= i - j <
window`` on a sliding layer and iff ``j <= i`` on a full one. cos and sin
are of ``position * inv_freq``, each frequency twice: on a sliding layer
``inv_freq = theta^(-2i/d)``; on a full layer YaRN's (``model["yarn"]``),
the extrapolated frequencies ``theta^(-2i/d)`` and the interpolated ones
``/ factor`` blended by a ramp from 0 at dimension ``floor(c(beta_fast))``
to 1 at ``ceil(c(beta_slow))``, ``c(r) = d ln(L / (2 pi r)) / (2 ln
theta)`` at the original context L, and cos and sin times
``attention_factor``.

Departures from the published model, also in the configuration file: no
multi-token-prediction head, no router auxiliary loss, no q/k norm (the
configuration declares none), plain SGD, no document masking (positions
0..S-1 over each row).

Attention runs in blocks of queries, each over the keys its mask can
reach, and every layer is checkpointed, so a b2 x s8192 step fits the card
beside nothing else. ``prec="fp8"`` is ``model.matmul``'s control: every
product's operands rounded to float8. ``fault`` plants what a run may get
wrong, in the reference put in the program's place: ``"window_ignored"``
(full causal attention on the sliding layers) and ``"top_k_less_one"``
(one expert fewer a token).

Imports nothing of the program; takes tensors that the benchmark made.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.model import matmul, norm

Params = Dict[str, torch.Tensor]

# Query rows of one attention block; rows of one block of the head.
Q_BLOCK = 1024
HEAD_ROWS = 4096
FAULTS = ("window_ignored", "top_k_less_one")


def rope(model: Dict[str, Any], kind: str, seq: int,
         device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``[seq, d_head]`` cos and sin of layer kind ``kind``."""
    d, theta = model["d_head"], float(model["rope_theta"])
    base = [theta ** (-2.0 * i / d) for i in range(d // 2)]
    scale = 1.0
    if kind == "full":
        y = model["yarn"]

        def c(rotations):
            return (d * math.log(y["original_max_position_embeddings"]
                                 / (2 * math.pi * rotations))
                    / (2 * math.log(theta)))

        lo = max(math.floor(c(y["beta_fast"])), 0)
        hi = min(math.ceil(c(y["beta_slow"])), d - 1)
        hi = hi + 0.001 if hi == lo else hi
        freqs = []
        for i, f in enumerate(base):
            ramp = min(max((i - lo) / (hi - lo), 0.0), 1.0)
            freqs.append(f / y["factor"] * ramp + f * (1.0 - ramp))
        base, scale = freqs, float(y["attention_factor"])
    inv = torch.tensor(base, dtype=torch.float64)
    ang = torch.arange(seq, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=1)
    return ((ang.cos() * scale).float().to(device),
            (ang.sin() * scale).float().to(device))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    half = x.shape[-1] // 2
    turned = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + turned * sin[:, None]


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _attend(q, k, v, first: int, key0: int, window: int, prec: str):
    """Queries ``first..`` ([B, H, n, Dh]) over keys ``key0..``."""
    scores = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(q.shape[-1])
    qpos = torch.arange(first, first + q.shape[2], device=q.device)[:, None]
    kpos = torch.arange(key0, key0 + k.shape[2], device=q.device)[None, :]
    hidden = kpos > qpos
    if window:
        hidden |= qpos - kpos >= window
    scores = scores.masked_fill(hidden, float("-inf"))
    return matmul(torch.softmax(scores, dim=-1), v, prec)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, prec: str) -> torch.Tensor:
    """``[B, S, H, Dh]`` attention, a block of queries at a time over the
    keys its mask reaches."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    grad = torch.is_grad_enabled() and q.requires_grad
    seq = q.shape[1]
    outs = []
    for s0 in range(0, seq, Q_BLOCK):
        s1 = min(seq, s0 + Q_BLOCK)
        k0 = max(0, s0 - window + 1) if window else 0
        args = (qh[:, :, s0:s1], kh[:, :, k0:s1], vh[:, :, k0:s1], s0, k0,
                window, prec)
        outs.append(checkpoint(_attend, *args, use_reentrant=False) if grad
                    else _attend(*args))
    return torch.cat(outs, dim=2).transpose(1, 2)


def experts(y: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
            w3: torch.Tensor, w2: torch.Tensor, top_k: int, prec: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer over rows ``y [N, D]``: its output, and the
    experts each row chose ``[N, top_k]``."""
    probs = torch.softmax(matmul(y, router, prec), dim=-1)
    top, chosen = probs.topk(top_k, dim=-1)
    weight = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(y)
    for e in range(router.shape[1]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = y[rows]
        he = F.silu(matmul(xe, w1[e], prec)) * matmul(xe, w3[e], prec)
        out = out.index_add(0, rows, matmul(he, w2[e], prec)
                            * weight[rows, slot, None])
    return out, chosen


def _layer(x: torch.Tensor, p: Sequence[torch.Tensor], cos, sin,
           model: Dict[str, Any], window: int, top_k: int, prec: str
           ) -> torch.Tensor:
    attn_norm, wq, wk, wv, wo, mlp_norm, router, w1, w3, w2 = p
    b, s, _ = x.shape
    h, kv, hd = model["n_heads"], model["n_kv_heads"], model["d_head"]
    eps = model["norm_eps"]
    y = _norm(x, attn_norm, eps)
    q = _rotate(matmul(y, wq, prec).view(b, s, h, hd), cos, sin)
    k = _rotate(matmul(y, wk, prec).view(b, s, kv, hd), cos, sin)
    v = matmul(y, wv, prec).view(b, s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    o = attention(q, k, v, window, prec).reshape(b, s, h * hd)
    x = x + matmul(o, wo, prec)
    y = _norm(x, mlp_norm, eps).reshape(b * s, -1)
    out, _ = experts(y, router, w1, w3, w2, top_k, prec)
    return x + out.view(b, s, -1)


LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router",
              "w1", "w3", "w2")


def hidden(params: Params, tokens: torch.Tensor, model: Dict[str, Any],
           prec: str = "f32", fault: Optional[str] = None) -> torch.Tensor:
    """The normed final hidden state ``[B, S, D]`` in f32."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    p = {k: v.float() for k, v in params.items()}
    x = p["embed"][tokens]
    top_k = model["top_k"] - (fault == "top_k_less_one")
    grad = torch.is_grad_enabled() and x.requires_grad
    for i, kind in enumerate(model["layer_types"][:model["layers"]]):
        cos, sin = rope(model, kind, tokens.shape[1], tokens.device)
        window = (model["window"] if kind == "sliding"
                  and fault != "window_ignored" else 0)
        args = (x, [p[f"layers.{i}.{k}"] for k in LAYER_KEYS], cos, sin,
                model, window, top_k, prec)
        x = (checkpoint(_layer, *args, use_reentrant=False) if grad
             else _layer(*args))
    return _norm(x, p["final_norm"], model["norm_eps"])


def _rows_loss(h: torch.Tensor, out: torch.Tensor, targets: torch.Tensor,
               keep: torch.Tensor, prec: str) -> torch.Tensor:
    lg = matmul(h, out, prec)
    tok = torch.logsumexp(lg, -1) - lg.gather(-1, targets[:, None])[:, 0]
    return (tok * keep).sum()


def loss(params: Params, tokens: torch.Tensor, targets: torch.Tensor,
         model: Dict[str, Any], prec: str = "f32",
         keep: Optional[torch.Tensor] = None,
         fault: Optional[str] = None) -> torch.Tensor:
    """Mean token cross-entropy; with a boolean ``keep`` over the tokens,
    the mean over the kept ones. The head runs ``HEAD_ROWS`` rows at a
    time, each block checkpointed."""
    h = hidden(params, tokens, model, prec, fault)
    rows = h.reshape(-1, h.shape[-1])
    t = targets.reshape(-1)
    kept = (torch.ones_like(t, dtype=torch.float32) if keep is None
            else keep.reshape(-1).float())
    out = params["out"].float()
    total = h.new_zeros(())
    for r0 in range(0, rows.shape[0], HEAD_ROWS):
        args = (rows[r0:r0 + HEAD_ROWS], out, t[r0:r0 + HEAD_ROWS],
                kept[r0:r0 + HEAD_ROWS], prec)
        total = total + (checkpoint(_rows_loss, *args, use_reentrant=False)
                         if h.requires_grad else _rows_loss(*args))
    return total / kept.sum()


def sgd(params0: Params, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        model: Dict[str, Any], lr: float, prec: str = "f32",
        keep: Optional[torch.Tensor] = None, fault: Optional[str] = None
        ) -> Tuple[List[float], Dict[str, float], Dict[str, float]]:
    """Plain SGD from ``params0`` over ``batches``, one step each: each
    step's loss, each leaf's norm of the first gradient, and each leaf's
    norm of its change after the last step. ``params0`` is not
    modified."""
    p = {k: v.detach().float() for k, v in params0.items()}
    losses: List[float] = []
    first: Dict[str, float] = {}
    for i, (tokens, targets) in enumerate(batches):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        value = loss(leaves, tokens, targets, model, prec, keep, fault)
        grads = torch.autograd.grad(value, list(leaves.values()))
        losses.append(float(value.detach()))
        if i == 0:
            first = {k: norm(g) for k, g in zip(leaves, grads)}
        with torch.no_grad():
            p = {k: v.detach() - lr * g for (k, v), g in zip(leaves.items(),
                                                            grads)}
        del leaves, grads, value
    change = {k: norm(p[k] - params0[k].float()) for k in p}
    return losses, first, change
