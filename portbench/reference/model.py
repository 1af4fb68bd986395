"""The plain reference of the burn-in block: plain PyTorch in float32,
TF32 off, attention in blocks of queries so that it fits at s8192.

The block: embedding; x += Wo attn(rms(x)); x += W2 gelu_tanh(W1 rms(x));
logits = rms(x) Wout. ``rms`` is an unweighted RMS norm (eps 1e-6),
attention is causal softmax(q k^T / sqrt(d_head)) v over ``heads``
heads, with no position signal. Loss: mean token cross-entropy. Training:
plain SGD, ``p - lr * g``.

``prec="fp8"`` is the control: every product takes its operands rounded
to float8 with one scale a tensor (e4m3 forward, e5m2 for gradients), the
step below the bfloat16 compute that the configurations state.

Imports nothing of the program; takes tensors that the benchmark made.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]

# Query rows of one attention block: [B, H, 1024, S] f32 scores a block.
Q_BLOCK = 1024


def pin_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under one scale for the whole tensor, back
    in f32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = torch.finfo(fmt).max / amax
    return (x.float() * scale).to(fmt).float().div_(scale)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):  # type: ignore[override]
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return a @ b
    if prec == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {prec!r}")


def rms(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, first: int,
            prec: str) -> torch.Tensor:
    """Queries ``first..first+len(q)`` ([B, H, n, Dh]) over keys
    ``0..len(k)``, causal."""
    scores = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(q.shape[-1])
    qpos = torch.arange(first, first + q.shape[2], device=q.device)
    kpos = torch.arange(k.shape[2], device=q.device)
    scores = scores.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    return matmul(torch.softmax(scores, dim=-1), v, prec)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              prec: str) -> torch.Tensor:
    """Causal attention over ``[B, S, H, Dh]``, a block of queries at a
    time; under autograd each block is recomputed in the backward rather
    than its scores kept."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    grad = torch.is_grad_enabled() and q.requires_grad
    seq = q.shape[1]
    outs = []
    for s0 in range(0, seq, Q_BLOCK):
        s1 = min(seq, s0 + Q_BLOCK)
        args = (qh[:, :, s0:s1], kh[:, :, :s1], vh[:, :, :s1], s0, prec)
        outs.append(checkpoint(_attend, *args, use_reentrant=False) if grad
                    else _attend(*args))
    return torch.cat(outs, dim=2).transpose(1, 2)


def hidden(params: Params, tokens: torch.Tensor, heads: int,
           prec: str = "f32") -> torch.Tensor:
    """The normed final hidden state ``[B, S, D]`` in f32."""
    p = {k: v.float() for k, v in params.items()}
    x = p["embed"][tokens]
    b, s, d = x.shape
    shape = (b, s, heads, d // heads)
    y = rms(x)
    q = matmul(y, p["wq"], prec).view(shape)
    k = matmul(y, p["wk"], prec).view(shape)
    v = matmul(y, p["wv"], prec).view(shape)
    x = x + matmul(attention(q, k, v, prec).reshape(b, s, d), p["wo"], prec)
    ff = F.gelu(matmul(rms(x), p["w1"], prec), approximate="tanh")
    x = x + matmul(ff, p["w2"], prec)
    return rms(x)


def logits(params: Params, tokens: torch.Tensor, heads: int,
           prec: str = "f32", rows: Optional[Sequence[int]] = None
           ) -> torch.Tensor:
    """f32 logits ``[B, S, V]``; with ``rows`` (positions of batch row 0),
    only those, ``[len(rows), V]``."""
    h = hidden(params, tokens, heads, prec)
    if rows is not None:
        h = h[0, torch.as_tensor(list(rows), device=h.device)]
    return matmul(h, params["out"].float(), prec)


def xent(lg: torch.Tensor, targets: torch.Tensor,
         keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; with a boolean ``keep`` over the tokens,
    the mean over the kept ones."""
    tok = torch.logsumexp(lg, -1) - lg.gather(-1, targets[..., None])[..., 0]
    return tok.mean() if keep is None else tok[keep].mean()


def sgd(params0: Params, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        heads: int, lr: float, prec: str = "f32",
        keep: Optional[torch.Tensor] = None
        ) -> Tuple[List[float], Dict[str, float], Dict[str, float]]:
    """Plain SGD from ``params0`` over ``batches``, one step each. Returns
    each step's loss, each leaf's norm of the first gradient, and each
    leaf's norm of its change after the last step. ``params0`` is not
    modified."""
    p = {k: v.detach().float() for k, v in params0.items()}
    losses: List[float] = []
    first: Dict[str, float] = {}
    for i, (tokens, targets) in enumerate(batches):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss = xent(logits(leaves, tokens, heads, prec), targets, keep)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        if i == 0:
            first = {k: norm(g) for k, g in zip(leaves, grads)}
        with torch.no_grad():
            p = {k: v.detach() - lr * g for (k, v), g in zip(leaves.items(),
                                                            grads)}
    change = {k: norm(p[k] - params0[k].float()) for k in p}
    return losses, first, change


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))
