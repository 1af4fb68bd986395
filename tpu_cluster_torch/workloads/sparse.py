"""A sparse decoder in the layout of Mellum2-12B-A2.5B: grouped-query
attention with rotary positions (YaRN on the full layers), sliding
windows on the others, and a routed SwiGLU expert layer in every block.

The model is trained through the burn-in's trainer: ``burnin.loss_fn``
dispatches on a :class:`SparseConfig` to :func:`loss_fn`, so
``burnin.train_step`` keeps its spans and ``burnin.sgd_update``, and the
model ends in ``burnin.lm_head`` and ``burnin.softmax_xent``. One block,
for layer ``i`` of ``cfg.layer_types``::

    y = rms_w(x) ; q, k, v = y Wq, y Wk, y Wv        (H query, KV key heads)
    q, k = rope(q), rope(k)                           (rotate-half layout)
    x += Wo attn(q, repeat_kv(k), repeat_kv(v))       (window on "sliding")
    x += moe(rms_w(x))

then ``logits = rms_w(x) Wout``. ``rms_w`` is the weighted RMS norm (eps
``norm_eps``). Query head h reads key head ``h // (H / KV)``, as Hugging
Face's ``repeat_kv``; the keys and values are repeated to H heads before
the attention kernels. A sliding layer lets query i see key j iff
``0 <= i - j < window``; a full layer is causal. Sliding layers take the
default rotary frequencies at ``rope_theta``; full layers take YaRN's
frequencies, and its ``attention_factor`` on cos and sin (:class:`Yarn`).

``moe``: router logits ``y Wr`` in f32, softmax over the experts, the
``top_k`` largest renormalised to sum to 1; each routed (token, expert)
pair computes ``W2_e (silu(W1_e y) * W3_e y)`` and the outputs are summed
by weight. Only routed pairs are computed, none padded to a capacity and
none dropped: the pairs are sorted by expert and the products grouped
over each expert's rows (``torch._grouped_mm``). Each of the layer's
four parts is a custom autograd Function, so that its span
(``telemetry.MOE_SPANS``) opens in the backward too. The experts' weights are cast to bf16 before
the ``moe.experts`` span opens, so that span holds the grouped products
and their activation alone. Given a :class:`RouteCounters`, the tokens
each expert took and the routed pairs the grouped products do not give
to their own expert are counted on the device, never read inside a
step.

bf16 compute, f32 master parameters in an ``[in, out]`` layout (experts
``[E, in, out]``), as the burn-in block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import telemetry as _telemetry
from ..kernels.flash_attention import flash_attention
from .burnin import lm_head, softmax_xent

_ROUTE, _DISPATCH, _EXPERTS, _COMBINE = _telemetry.MOE_SPANS

SLIDING, FULL = "sliding", "full"


@dataclass(frozen=True)
class Yarn:
    """YaRN's rotary scaling as transformers' ``_compute_yarn_parameters``
    reads it from a ``rope_parameters`` group."""

    factor: float = 16.0
    original_max_position_embeddings: int = 8192
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float = 1.2772588722239782


class RouteCounters:
    """Counts of the expert layers, kept on the device: per layer the
    tokens each expert took, summed over the calls, and the routed pairs
    that the grouped products do not compute with their own expert (a
    row past the last group, or in another expert's group: what a
    capacity, or a wrong sort or offset, would leave). :meth:`read`
    syncs once."""

    def __init__(self, layers: int, experts: int,
                 device: torch.device) -> None:
        self.tokens = torch.zeros((layers, experts), dtype=torch.int64,
                                  device=device)
        self.dropped = torch.zeros((), dtype=torch.int64, device=device)

    def add(self, layer: int, counts: torch.Tensor,
            dropped: torch.Tensor) -> None:
        self.tokens[layer] += counts
        self.dropped += dropped

    def reset(self) -> None:
        self.tokens.zero_()
        self.dropped.zero_()

    def read(self) -> Dict[str, object]:
        """The pairs not computed, and per layer the busiest expert's
        tokens over the mean expert's."""
        tokens = self.tokens.float()
        return {"dropped_tokens": int(self.dropped),
                "expert_load_max_over_mean": (tokens.amax(1)
                                              / tokens.mean(1)).tolist()}


@dataclass(frozen=True)
class SparseConfig:
    """Widths, the layer pattern and the learning rate. The defaults are
    a CPU-test size; the benchmark's configuration file gives the
    published widths."""

    vocab: int = 256
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_head: int = 128
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 64
    layer_types: Tuple[str, ...] = (SLIDING, SLIDING, SLIDING, FULL)
    window: int = 16
    rope_theta: float = 500000.0
    yarn: Optional[Yarn] = Yarn()
    norm_eps: float = 1e-6
    lr: float = 1e-3


def _check(cfg: SparseConfig) -> None:
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"n_heads {cfg.n_heads} is no multiple of "
                         f"n_kv_heads {cfg.n_kv_heads}")
    if not 1 <= cfg.top_k <= cfg.n_experts:
        raise ValueError(f"top_k {cfg.top_k} not in 1..{cfg.n_experts}")
    if set(cfg.layer_types) - {SLIDING, FULL}:
        raise ValueError(f"layer types {cfg.layer_types}")


def param_table(cfg: SparseConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                      Optional[float]]]:
    """Each parameter's shape and init scale (``None``: ones, a norm's
    weight), in the order the model reads them. The embedding's rows
    start at unit RMS, so that each token's own state, more than what
    attention averages over the context, decides its route: at 0.02 the
    averaged part dominates at long contexts and every token takes the
    same experts."""
    d, hd = cfg.d_model, cfg.d_head
    q, kv, e, f = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_experts, \
        cfg.d_expert
    out: Dict[str, Tuple[Tuple[int, ...], Optional[float]]] = {
        "embed": ((cfg.vocab, d), 1.0)}
    for i in range(len(cfg.layer_types)):
        out.update({
            f"layers.{i}.attn_norm": ((d,), None),
            f"layers.{i}.wq": ((d, q), d ** -0.5),
            f"layers.{i}.wk": ((d, kv), d ** -0.5),
            f"layers.{i}.wv": ((d, kv), d ** -0.5),
            f"layers.{i}.wo": ((q, d), q ** -0.5),
            f"layers.{i}.mlp_norm": ((d,), None),
            f"layers.{i}.router": ((d, e), d ** -0.5),
            f"layers.{i}.w1": ((e, d, f), d ** -0.5),
            f"layers.{i}.w3": ((e, d, f), d ** -0.5),
            f"layers.{i}.w2": ((e, f, d), f ** -0.5),
        })
    out["final_norm"] = ((d,), None)
    out["out"] = ((d, cfg.vocab), d ** -0.5)
    return out


def init_params(cfg: SparseConfig, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """f32 parameters drawn from ``generator`` (on ``device``); norms
    start at one."""
    out = {}
    for name, (shape, scale) in param_table(cfg).items():
        if scale is None:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.randn(shape, generator=generator,
                                    device=device).mul_(scale)
    return out


# ------------------------------------------------------------- positions

def rope_inv_freq(d_head: int, theta: float, yarn: Optional[Yarn] = None,
                  device: Optional[torch.device] = None
                  ) -> Tuple[torch.Tensor, float]:
    """The f32 ``[d_head / 2]`` rotary frequencies, made on ``device``,
    and the factor cos and sin are scaled by: the default rope, or YaRN's
    blend of interpolated and extrapolated frequencies with a linear ramp
    between the correction dimensions of ``beta_fast`` and ``beta_slow``
    rotations (floored and ceiled, as transformers' ``truncate``)."""
    pos = theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                 device=device) / d_head)
    if yarn is None:
        return 1.0 / pos, 1.0

    def correction_dim(rotations: float) -> float:
        return (d_head * math.log(yarn.original_max_position_embeddings
                                  / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(yarn.beta_fast)), 0)
    high = min(math.ceil(correction_dim(yarn.beta_slow)), d_head - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d_head // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    extrapolated = 1 - ramp
    inv = ((1.0 / (yarn.factor * pos)) * (1 - extrapolated)
           + (1.0 / pos) * extrapolated)
    return inv, yarn.attention_factor


def rope_tables(cfg: SparseConfig, kind: str, seq: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``[seq, d_head]`` cos and sin at positions ``0..seq-1``, each
    frequency twice (rotate-half layout), times the layer's attention
    factor; made on ``device``, so no copy waits on it."""
    inv, scale = rope_inv_freq(cfg.d_head, cfg.rope_theta,
                               cfg.yarn if kind == FULL else None, device)
    ang = torch.outer(torch.arange(seq, dtype=torch.float32, device=device),
                      inv)
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos() * scale, ang.sin() * scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """``x * cos + rotate_half(x) * sin`` over ``[B, S, H, D]``, in f32,
    rounded once to ``x``'s dtype."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, None] + rot * sin[:, None]).to(x.dtype)


def rms_w(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Weighted RMS norm: mean of squares in f32, its rsqrt in ``x``'s
    dtype, times the weight in that dtype."""
    ms = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + eps).to(x.dtype) * w.to(x.dtype)


# ------------------------------------------------------ the expert layer

class _Route(torch.autograd.Function):
    """f32 router logits ``y Wr``, softmax, the ``k`` largest and their
    renormalised weights: ``(weights [N, k] f32, experts [N, k])``."""

    @staticmethod
    def forward(ctx, y, wr, k, tel):  # type: ignore[override]
        probs = torch.softmax(y.float() @ wr, dim=-1)
        top, experts = probs.topk(k, dim=-1)
        total = top.sum(-1, keepdim=True)
        weights = top / total
        ctx.save_for_backward(y, wr, probs, experts, weights, total)
        ctx.tel = tel
        ctx.mark_non_differentiable(experts)
        return weights, experts

    @staticmethod
    def backward(ctx, dw, _):  # type: ignore[override]
        with _telemetry.maybe_span(ctx.tel, _ROUTE, "train", phase="bwd"):
            y, wr, probs, experts, weights, total = ctx.saved_tensors
            dtop = (dw - (dw * weights).sum(-1, keepdim=True)) / total
            dp = torch.zeros_like(probs).scatter_(-1, experts, dtop)
            dl = probs * (dp - (dp * probs).sum(-1, keepdim=True))
            dy = (dl @ wr.t()).to(y.dtype)
            dwr = y.float().t() @ dl
        return dy, dwr, None, None


class _Dispatch(torch.autograd.Function):
    """The rows of the routed pairs in expert order: ``y[token]``."""

    @staticmethod
    def forward(ctx, y, token, inverse, k, tel):  # type: ignore[override]
        ctx.save_for_backward(inverse)
        ctx.k, ctx.tel = k, tel
        return y.index_select(0, token)

    @staticmethod
    def backward(ctx, dxs):  # type: ignore[override]
        with _telemetry.maybe_span(ctx.tel, _DISPATCH, "train", phase="bwd"):
            (inverse,) = ctx.saved_tensors
            # each token's k rows, summed (bf16 with f32 accumulation)
            dy = dxs.index_select(0, inverse).view(-1, ctx.k,
                                                   dxs.shape[-1]).sum(1)
        return dy, None, None, None, None


def _gmm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor
         ) -> torch.Tensor:
    """``[M, K] x [E, K, N] -> [M, N]``: each expert's contiguous rows
    (``offs``, the cumulative row counts) times its matrix."""
    return torch._grouped_mm(a, b, offs=offs)


def _gmm_k(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor,
           empty: torch.Tensor) -> torch.Tensor:
    """``[K, M] x [M, N] -> [E, K, N]``: each expert's rows summed out
    (a weight gradient); an expert with no rows (``empty``) gets
    zeros."""
    out = torch._grouped_mm(a, b, offs=offs)
    return out.masked_fill_(empty[:, None, None], 0)


class _Experts(torch.autograd.Function):
    """``W2_e (silu(W1_e x) * W3_e x)`` over each expert's rows of ``xs``
    (bf16); backward by the same grouped products."""

    @staticmethod
    def forward(ctx, xs, w1, w3, w2, offs, tel):  # type: ignore[override]
        h1 = _gmm(xs, w1, offs)
        h3 = _gmm(xs, w3, offs)
        a = F.silu(h1) * h3
        ctx.save_for_backward(xs, w1, w3, w2, offs, h1, h3, a)
        ctx.tel = tel
        return _gmm(a, w2, offs)

    @staticmethod
    def backward(ctx, dys):  # type: ignore[override]
        with _telemetry.maybe_span(ctx.tel, _EXPERTS, "train", phase="bwd"):
            xs, w1, w3, w2, offs, h1, h3, a = ctx.saved_tensors
            empty = offs.diff(prepend=offs.new_zeros(1)) == 0
            dys = dys.contiguous()
            da = _gmm(dys, w2.transpose(-1, -2), offs).float()
            dw2 = _gmm_k(a.t(), dys, offs, empty)
            g1 = h1.float()
            sig = torch.sigmoid(g1)
            dh3 = (da * g1 * sig).to(xs.dtype)
            dh1 = (da * h3.float() * sig * (1 + g1 * (1 - sig))).to(xs.dtype)
            dxs = _gmm(dh1, w1.transpose(-1, -2), offs)
            dxs += _gmm(dh3, w3.transpose(-1, -2), offs)
            dw1 = _gmm_k(xs.t(), dh1, offs, empty)
            dw3 = _gmm_k(xs.t(), dh3, offs, empty)
        return dxs, dw1, dw3, dw2, None, None


class _Combine(torch.autograd.Function):
    """Each token's ``k`` expert outputs (rows ``inverse`` of ``ys``)
    summed by their weights."""

    @staticmethod
    def forward(ctx, ys, weights, inverse, order, tel):  # type: ignore[override]
        n, k = weights.shape
        mine = ys.index_select(0, inverse).view(n, k, ys.shape[-1])
        w = weights.to(ys.dtype)
        ctx.save_for_backward(mine, w, order)
        ctx.tel = tel
        return torch.bmm(w[:, None], mine)[:, 0]

    @staticmethod
    def backward(ctx, dout):  # type: ignore[override]
        with _telemetry.maybe_span(ctx.tel, _COMBINE, "train", phase="bwd"):
            mine, w, order = ctx.saved_tensors
            dout = dout.contiguous()
            dw = torch.bmm(mine, dout[:, :, None])[..., 0].float()
            dmine = w[:, :, None] * dout[:, None]
            dys = dmine.view(-1, dout.shape[-1]).index_select(0, order)
        return dys, dw, None, None, None


def group_offsets(flat: torch.Tensor, n_experts: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows each expert takes of the routed pairs ``flat`` (their
    experts), and the int32 cumulative counts that bound each expert's
    group of rows in expert order."""
    # (bincount would wait for the device to size its output)
    counts = torch.zeros(n_experts, dtype=torch.int64,
                         device=flat.device).scatter_add_(
                             0, flat, torch.ones_like(flat))
    return counts, counts.cumsum(0).to(torch.int32)


def moe(y: torch.Tensor, params: Dict[str, torch.Tensor], prefix: str,
        cfg: SparseConfig, layer: int,
        tel: Optional[_telemetry.Telemetry] = None,
        counters: Optional[RouteCounters] = None) -> torch.Tensor:
    """The routed expert layer over bf16 rows ``y [N, D]``: ``[N, D]``."""
    bf16 = torch.bfloat16
    n, k = y.shape[0], cfg.top_k
    w1, w3, w2 = (params[prefix + w].to(bf16) for w in ("w1", "w3", "w2"))
    with _telemetry.maybe_span(tel, _ROUTE, "train", phase="fwd",
                               layer=layer):
        weights, experts = _Route.apply(y, params[prefix + "router"], k, tel)
    with _telemetry.maybe_span(tel, _DISPATCH, "train", phase="fwd",
                               layer=layer):
        flat = experts.reshape(-1)
        # routed pairs in expert order; pair n * k + j is token n's j-th
        order = torch.argsort(flat, stable=True)
        inverse = torch.argsort(order)
        counts, offs = group_offsets(flat, cfg.n_experts)
        if counters is not None:
            # the group each row falls in, whose matrix the grouped
            # products take, against its pair's own expert
            rows = torch.arange(n * k, dtype=torch.int32, device=flat.device)
            group = torch.searchsorted(offs, rows, right=True)
            counters.add(layer, counts, (group != flat[order]).sum())
        xs = _Dispatch.apply(y, order // k, inverse, k, tel)
    with _telemetry.maybe_span(tel, _EXPERTS, "train", phase="fwd",
                               layer=layer):
        ys = _Experts.apply(xs, w1, w3, w2, offs, tel)
    with _telemetry.maybe_span(tel, _COMBINE, "train", phase="fwd",
                               layer=layer):
        return _Combine.apply(ys, weights, inverse, order, tel)


# ------------------------------------------------------------- the model

def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: SparseConfig,
            telemetry: Optional[_telemetry.Telemetry] = None,
            counters: Optional[RouteCounters] = None) -> torch.Tensor:
    """f32 ``[B, S, vocab]`` logits of integer ``tokens [B, S]``; the
    expert layers' spans on ``telemetry``, their counts on
    ``counters``."""
    _check(cfg)
    bf16 = torch.bfloat16
    b, s = tokens.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    eps = cfg.norm_eps
    x = params["embed"][tokens].to(bf16)
    for i, kind in enumerate(cfg.layer_types):
        p = f"layers.{i}."
        y = rms_w(x, params[p + "attn_norm"], eps)
        cos, sin = rope_tables(cfg, kind, s, tokens.device)
        q = apply_rope((y @ params[p + "wq"].to(bf16)).view(b, s, h, hd),
                       cos, sin)
        k = apply_rope((y @ params[p + "wk"].to(bf16)).view(b, s, kv, hd),
                       cos, sin)
        v = (y @ params[p + "wv"].to(bf16)).view(b, s, kv, hd)
        # query head j reads key head j // (h / kv)
        k, v = (t[:, :, :, None].expand(b, s, kv, h // kv, hd)
                .reshape(b, s, h, hd) for t in (k, v))
        o = flash_attention(q, k, v, hd ** -0.5,
                            cfg.window if kind == SLIDING else 0)
        x = x + o.reshape(b, s, h * hd) @ params[p + "wo"].to(bf16)
        y = rms_w(x, params[p + "mlp_norm"], eps)
        x = x + moe(y.reshape(b * s, -1), params, p, cfg, i, telemetry,
                    counters).view(b, s, -1)
    y = rms_w(x, params["final_norm"], eps)
    return lm_head(y, params["out"].to(bf16))


def loss_fn(params: Dict[str, torch.Tensor],
            batch: Tuple[torch.Tensor, torch.Tensor], cfg: SparseConfig,
            telemetry: Optional[_telemetry.Telemetry] = None,
            counters: Optional[RouteCounters] = None) -> torch.Tensor:
    """Mean token cross-entropy of :func:`forward` on ``(tokens,
    targets)``."""
    tokens, targets = batch
    return softmax_xent(forward(params, tokens, cfg, telemetry, counters),
                        targets)
