"""The burn-in transformer block in PyTorch: serving, single-card and
sharded training.

Port of ``tpu_cluster/workloads/burnin.py``: the same configuration,
parameters (shapes, scales, dtypes, ``[in, out]`` layout so ``y @ W``
reads the same in both packages), forward numerics, fused cross-entropy,
remat policies, SGD step, sharded step and ``run``, on a torch device.
``attention="flash"`` runs the hand-written Hopper kernels
(:mod:`tpu_cluster_torch.kernels.flash_attention`: K1 forward, K2 and K3
backward) on CUDA tensors and their plain versions on CPU tensors.

``python -m tpu_cluster_torch.workloads.burnin`` trains the default
configuration for 5 steps on the card and prints ``run``'s JSON.
:func:`timed_steps` measures training throughput with the shared
two-point estimator, against the model FLOPs of :func:`flops_per_step`.

Sharded training (:func:`make_mesh`, :func:`make_sharded_step`) runs one
rank a device on a ``("data", "model")`` device mesh: the reference's
:func:`param_specs` layout, which GSPMD partitions there, written out as
Megatron collectives (:mod:`.tensor_parallel`), and a mean all-reduce of
the gradients over ``"data"``.

Matrix-product precision is pinned at import for the whole process:
float32 products run in full float32 (no TF32), and bf16 products reduce
in full precision, so the f32 score products below are the exact-product
f32 sums the reference's ``preferred_element_type=f32`` asks for. The LM
head (:class:`_LMHead`) is a bf16 product with f32 output on the card.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)
from torch.utils.flop_counter import FlopCounterMode

from . import runtime_metrics, timing
from .tensor_parallel import (ModelAxis, copy_to_model, embed_lookup,
                              reduce_from_model, vocab_parallel_xent)
from ..kernels.flash_attention import (BLOCK, SUPPORTED_HEAD_DIMS,
                                       flash_attention)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` means the card: ``torch.device("cuda")``. The CPU is used
    only when a caller asks for it."""
    return torch.device("cuda" if device is None else device)


@dataclass(frozen=True)
class BurninConfig:
    """Same fields and defaults as the reference's ``BurninConfig``; see
    its comments for what each knob selects."""

    vocab: int = 256
    d_model: int = 128
    d_ff: int = 512
    n_heads: int = 4
    seq: int = 64
    batch: int = 8
    lr: float = 1e-3
    remat: str = "none"
    attention: str = "xla"
    attn_block: int = 128
    score_dtype: str = "f32"
    param_dtype: str = "f32"


def _param_table(cfg: BurninConfig
                 ) -> Tuple[torch.dtype, Dict[str, Tuple[Tuple[int, int],
                                                          float]]]:
    """The parameters' dtype, and each one's shape and init scale."""
    if cfg.param_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown param_dtype={cfg.param_dtype!r}")
    d, f = cfg.d_model, cfg.d_ff
    dtype = torch.bfloat16 if cfg.param_dtype == "bf16" else torch.float32
    return dtype, {
        "embed": ((cfg.vocab, d), 0.02),
        "wq": ((d, d), d ** -0.5),
        "wk": ((d, d), d ** -0.5),
        "wv": ((d, d), d ** -0.5),
        "wo": ((d, d), d ** -0.5),
        "w1": ((d, f), d ** -0.5),
        "w2": ((f, d), f ** -0.5),
        "out": ((d, cfg.vocab), d ** -0.5),
    }


def init_params(cfg: BurninConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random parameters with the reference's shapes, scales and dtypes,
    drawn from ``generator`` (which must live on ``device``). The numbers
    differ from ``jax.random``'s; :func:`params_from_jax` carries the
    reference's own across."""
    dtype, table = _param_table(cfg)
    dev = resolve_device(device)

    def norm(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    return {name: norm(shape, scale) for name, (shape, scale) in table.items()}


def params_from_jax(np_params: Dict[str, Any],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The reference's parameters (``burnin.init_params``, as numpy
    arrays) as the port's tensors on ``device``, in the same ``[in, out]``
    layout. bf16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    does not take) go through float32, a lossless round trip."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        arr = np.asarray(arr)
        dtype = torch.bfloat16 if arr.dtype.name == "bfloat16" \
            else torch.float32
        # a copy: jax hands out read-only buffers
        host = torch.from_numpy(np.array(arr, dtype=np.float32))
        out[name] = host.to(dtype).to(dev)
    return out


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       d_head: int, block: int) -> torch.Tensor:
    """Causal attention by the online-softmax recurrence over KV blocks,
    f32 running max and denominator, a ``[B, S, H, block]`` score tile
    per step: the reference's ``lax.scan`` as a torch loop."""
    scale = 1.0 / math.sqrt(d_head)
    b, s, h, d = q.shape
    if s % block != 0:
        raise ValueError(f"seq {s} not divisible by attn_block {block}")
    qf = q.float()
    qpos = torch.arange(s, device=q.device)[None, :, None, None]
    m = torch.full((b, s, h, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, s, h, 1), device=q.device)
    o = torch.zeros((b, s, h, d), device=q.device)
    for idx in range(s // block):
        kblk = k[:, idx * block:(idx + 1) * block].float()
        vblk = v[:, idx * block:(idx + 1) * block].float()
        sblk = torch.einsum("bqhd,bkhd->bqhk", qf, kblk) * scale
        kpos = idx * block + torch.arange(block, device=q.device)
        sblk = torch.where(qpos >= kpos[None, None, None, :], sblk,
                           torch.tensor(-1e30, device=q.device))
        m_new = torch.maximum(m, sblk.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sblk - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum(
            "bqhk,bkhd->bqhd", p.to(torch.bfloat16).float(), vblk)
        m = m_new
    return (o / l).to(torch.bfloat16)


def _check_knobs(cfg: BurninConfig) -> None:
    """The reference's knob guards, with its messages: an unrecognised
    mode must never fall through to a default path under another label."""
    if cfg.attention not in ("xla", "flash", "chunked"):
        raise ValueError(f"unknown attention={cfg.attention!r}; "
                         "expected xla|flash|chunked")
    if cfg.score_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown score_dtype={cfg.score_dtype!r}")
    if cfg.param_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown param_dtype={cfg.param_dtype!r}")
    if cfg.score_dtype == "bf16" and cfg.attention != "xla":
        raise ValueError(
            "score_dtype='bf16' applies to the 'xla' attention path only "
            "(flash/chunked manage score storage internally); a silent "
            "no-op here would mislabel the measured config")
    if cfg.remat == "attn" and cfg.attention != "xla":
        raise ValueError(
            "remat='attn' checkpoints the 'xla' attention block only "
            "(flash/chunked rematerialise internally); a silent no-op "
            "here would mislabel the measured config")
    if cfg.attention == "chunked" and cfg.seq % cfg.attn_block != 0:
        raise ValueError(
            f"attention='chunked' needs seq ({cfg.seq}) divisible by "
            f"attn_block ({cfg.attn_block})")


def _rms(v: torch.Tensor) -> torch.Tensor:
    # mean of squares in f32, rsqrt cast back to the input dtype
    ms = v.float().square().mean(-1, keepdim=True)
    return v * torch.rsqrt(ms + 1e-6).to(v.dtype)


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   d_head: int, score_dtype: str) -> torch.Tensor:
    """The reference's "xla" path: materialised f32 [B,H,S,S] scores (the
    product of the up-cast bf16 operands), an additive -1e30 causal mask,
    softmax in f32 (or on bf16-stored scores), bf16 P V."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(d_head)
    seq = q.shape[1]
    mask = torch.triu(torch.full((seq, seq), -1e30, device=q.device), 1)
    x = logits + mask
    if score_dtype == "bf16":
        attn = torch.softmax(x.to(torch.bfloat16), dim=-1)
    else:
        attn = torch.softmax(x, dim=-1).to(torch.bfloat16)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


class _LMHead(torch.autograd.Function):
    """The LM head: ``[N, D] @ [D, V]`` of two bf16 matrices, f32 logits
    out, never rounded to bf16 — the reference's einsum with
    ``preferred_element_type=f32`` (``burnin.py:267-269``). A product of
    two bf16 numbers is exact in f32, so routes differ only in the order
    of the f32 sums. The route is chosen by the operands' device:

    - CUDA: the tensor cores, ``torch.mm(..., out_dtype=torch.float32)``
      (a cuBLAS bf16 GEMM with f32 output). Both gradient products take
      the f32 cotangent ``g``; it is split into ``g_hi + g_lo``, both
      bf16 (``g_lo = g - g_hi`` is exact in f32), and each gradient is
      the sum of two such products: about 16 mantissa bits of ``g``,
      far finer than the bf16 rounding of the results. Not TF32, which
      keeps 10 bits of ``g`` and is a process-wide switch that another
      thread would see (it stays off, above). A failure raises: there is
      no fallback.
    - Any other device (the CPU, which has no kernel for
      ``aten::mm.dtype``; ``meta`` in :func:`flops_per_step`): the f32
      product of the up-cast operands, forward and backward.

    The gradients are rounded to bf16, the operands' dtype, as the
    reference rounds them."""

    @staticmethod
    def forward(ctx, y, w):  # type: ignore[override]
        ctx.save_for_backward(y, w)
        if y.device.type == "cuda":
            return torch.mm(y, w, out_dtype=torch.float32)
        return y.float() @ w.float()

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        y, w = ctx.saved_tensors
        dy = dw = None
        if y.device.type == "cuda":
            hi = g.to(torch.bfloat16)
            lo = (g - hi).to(torch.bfloat16)
            f32 = torch.float32
            if ctx.needs_input_grad[0]:
                dy = torch.mm(hi, w.t(), out_dtype=f32).add_(
                    torch.mm(lo, w.t(), out_dtype=f32))
            if ctx.needs_input_grad[1]:
                dw = torch.mm(y.t(), hi, out_dtype=f32).add_(
                    torch.mm(y.t(), lo, out_dtype=f32))
        else:
            if ctx.needs_input_grad[0]:
                dy = g @ w.float().t()
            if ctx.needs_input_grad[1]:
                dw = y.float().t() @ g
        return (None if dy is None else dy.to(y.dtype),
                None if dw is None else dw.to(w.dtype))


def lm_head(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 ``[..., V]`` logits of bf16 ``y [..., D]`` and ``w [D, V]``
    (see :class:`_LMHead`)."""
    lead = y.shape[:-1]
    out = _LMHead.apply(y.reshape(-1, y.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: BurninConfig, axis: Optional[ModelAxis] = None
            ) -> torch.Tensor:
    """One pre-norm transformer block + LM head: bf16 compute, f32
    ``[B, S, vocab]`` logits. ``tokens`` is an integer ``[B, S]`` tensor
    on the parameters' device.

    With a model ``axis`` the parameters are this rank's shards
    (:func:`shard_params`): ``H / tp`` heads, ``F / tp`` hidden units and
    ``vocab / tp`` embedding rows and logit columns, and the result is
    this rank's ``[B, S, vocab / tp]`` slice of the logits."""
    _check_knobs(cfg)
    bf16 = torch.bfloat16
    x = embed_lookup(params["embed"], tokens, axis).to(bf16)   # [B, S, D]
    h = cfg.n_heads // (1 if axis is None else axis.size)
    d_head = cfg.d_model // cfg.n_heads
    shape = (*x.shape[:2], h, d_head)

    y = copy_to_model(_rms(x), axis)
    q = (y @ params["wq"].to(bf16)).reshape(shape)
    k = (y @ params["wk"].to(bf16)).reshape(shape)
    v = (y @ params["wv"].to(bf16)).reshape(shape)
    if cfg.attention == "flash":
        o = flash_attention(q, k, v, 1.0 / math.sqrt(d_head))
    elif cfg.attention == "chunked":
        o = _chunked_attention(q, k, v, d_head, cfg.attn_block)
    elif cfg.remat == "attn" and torch.is_grad_enabled():
        # recompute the attention block in the backward instead of saving
        # its [B,H,S,S] tensors (the reference's jax.checkpoint(attn_block))
        o = checkpoint(_xla_attention, q, k, v, d_head, cfg.score_dtype,
                       use_reentrant=False)
    else:
        o = _xla_attention(q, k, v, d_head, cfg.score_dtype)
    o = o.reshape(*x.shape[:2], h * d_head)
    x = x + reduce_from_model(o @ params["wo"].to(bf16), axis)
    y = copy_to_model(_rms(x), axis)
    ff = F.gelu(y @ params["w1"].to(bf16), approximate="tanh")
    x = x + reduce_from_model(ff @ params["w2"].to(bf16), axis)
    return lm_head(copy_to_model(_rms(x), axis), params["out"].to(bf16))


class _SoftmaxXent(torch.autograd.Function):
    """Mean token cross-entropy with the reference's hand-fused backward
    (``burnin.py:272-305``): forward mean(logsumexp - gold logit), which
    never materialises the [B,S,V] log-probabilities; backward the closed
    form (softmax - onehot) * g / N in one pass, in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, targets):  # type: ignore[override]
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[..., None].long())[..., 0]
        ctx.save_for_backward(logits, targets, lse)
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, g):  # type: ignore[override]
        logits, targets, lse = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, targets[..., None].long(),
                       torch.full_like(d[..., :1], -1.0))
        return d.mul_(g / math.prod(logits.shape[:-1])), None


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of ``[..., V]`` logits against integer
    targets, differentiable in the logits (see :class:`_SoftmaxXent`)."""
    return _SoftmaxXent.apply(logits, targets)


# Matrix products without batch dimensions: what the reference's
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps. In this
# forward they are the projections, the FFN and the LM head (``x @ W``
# dispatches to aten.mm, the head on the card to aten.mm.dtype); the attention products carry batch and head
# dimensions (aten.bmm) and are recomputed, as is everything else.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
         torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_saveable)


def loss_fn(params: Dict[str, torch.Tensor],
            batch: Tuple[torch.Tensor, torch.Tensor],
            cfg: BurninConfig, axis: Optional[ModelAxis] = None
            ) -> torch.Tensor:
    """Mean cross-entropy of :func:`forward` on ``batch = (tokens,
    targets)``, with the reference's remat policies (``burnin.py:308-318``):
    "dots" saves only the outputs of products without batch dimensions
    (a selective ``torch.utils.checkpoint``), "full" checkpoints the whole
    forward, "attn" checkpoints the "xla" attention block inside
    :func:`forward`, anything else saves everything. With a model
    ``axis`` the cross-entropy runs over the split vocabulary."""
    tokens, targets = batch
    if cfg.remat == "dots":
        logits = checkpoint(forward, params, tokens, cfg, axis,
                            use_reentrant=False, context_fn=_save_dots)
    elif cfg.remat == "full":
        logits = checkpoint(forward, params, tokens, cfg, axis,
                            use_reentrant=False)
    else:
        logits = forward(params, tokens, cfg, axis)
    if axis is None:
        return softmax_xent(logits, targets)
    return vocab_parallel_xent(logits, targets, axis)


def loss_and_grads(params: Dict[str, torch.Tensor],
                   batch: Tuple[torch.Tensor, torch.Tensor],
                   cfg: BurninConfig, axis: Optional[ModelAxis] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its gradient with respect to every parameter (each in
    its parameter's dtype); ``params`` are not modified."""
    leaves = {name: p.detach().requires_grad_() for name, p in params.items()}
    loss = loss_fn(leaves, batch, cfg, axis)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_step(params: Dict[str, torch.Tensor],
               batch: Tuple[torch.Tensor, torch.Tensor],
               cfg: BurninConfig
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One plain-SGD step, ``p - lr * g`` for every parameter
    (``burnin.py:321-324``): returns ``(new_params, loss)`` with new
    tensors; ``params`` are not modified. Each update is computed in f32
    and rounded once to the parameter's dtype (for bf16 parameters, the
    single rounding XLA's fused update gives the reference)."""
    loss, grads = loss_and_grads(params, batch, cfg)
    return sgd_update(params, grads, cfg.lr), loss


def sgd_update(params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], lr: float
               ) -> Dict[str, torch.Tensor]:
    """``p - lr * g`` for every parameter, in new tensors: computed in f32
    and rounded once to the parameter's dtype."""
    with torch.no_grad():
        return {name: (p.float() - lr * grads[name].float()).to(p.dtype)
                for name, p in params.items()}


def standard_config() -> BurninConfig:
    """Standard-geometry shape: d4096/f16384/h16 (d_head 256) is GPT-J-6B's
    block geometry, with vocab 8192, as in the reference."""
    return BurninConfig(vocab=8192, d_model=4096, d_ff=16384,
                        n_heads=16, seq=512, batch=8)


def bench_config() -> BurninConfig:
    """The reference's bench train-step configuration, d2048/f131072/h16
    (d_head 128), vocab 8192: the one reference shape at the kernels'
    other head width."""
    return BurninConfig(vocab=8192, d_model=2048, d_ff=131072,
                        n_heads=16, seq=512, batch=8)


# The H100's own crossover, measured by kernels/crossover.py on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit (PERF.md section 6, "The flash
# crossover"): the smallest grid seq from which flash beats the "xla"
# path by more than the spread on the serving and training paths at both
# head widths, at that seq and every larger one (crossover.pick_crossover).
# Eight recorded runs picked 256 to 2048; the constant is the largest: on
# runs 5 and 7 the training path at d_head 256 won at s1024 by less than
# its spread. The reference's TPU value is 8192.
FLASH_CROSSOVER_SEQ = 2048


def select_attention(cfg: BurninConfig, platform: str) -> str:
    """The attention mode for ``cfg`` on ``platform`` (a torch device
    type): the reference's selector with "cuda" where it has "tpu".

    - "flash" iff on CUDA, at or past ``FLASH_CROSSOVER_SEQ``, with a head
      width the kernel is built for (128 or 256, within the reference's
      multiple-of-128 rule) and seq a multiple of its 64-row tile. Never
      on the CPU.
    - An explicit "chunked" request is honoured where seq % attn_block
      == 0, the guard ``forward`` would raise on otherwise.
    - Everything else: "xla".
    """
    if (platform == "cuda" and cfg.seq >= FLASH_CROSSOVER_SEQ
            and cfg.d_model // cfg.n_heads in SUPPORTED_HEAD_DIMS
            and cfg.seq % BLOCK == 0):
        return "flash"
    if cfg.attention == "chunked" and cfg.seq % cfg.attn_block == 0:
        return "chunked"
    return "xla"


def flops_per_step(cfg: BurninConfig) -> int:
    """Model FLOPs of one training step of ``cfg``: the matrix products of
    one ``loss_and_grads`` (forward and backward; the SGD update's
    elementwise work is not counted), as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them, on the
    ``meta`` device (shapes only, nothing computed or allocated).

    The count is taken with ``remat="none"`` and ``attention="xla"``
    whatever ``cfg`` says: recomputation adds no model work, and the flash
    kernels (ctypes launches) are invisible to the counter. So attention
    counts at full S^2, as the reference's ``xla`` path does, and the
    denominator of every rate is the model's work, independent of how it
    was implemented. It equals the closed form
    ``3 * (2*B*S*(4*D^2 + 2*D*F + D*V) + 4*B*S^2*D)``."""
    cfg = replace(cfg, remat="none", attention="xla")
    dtype, table = _param_table(cfg)
    meta = torch.device("meta")
    params = {name: torch.empty(shape, dtype=dtype, device=meta)
              for name, (shape, _) in table.items()}
    tokens = torch.empty((cfg.batch, cfg.seq), dtype=torch.int64,
                         device=meta)
    with FlopCounterMode(display=False) as counter:
        loss_and_grads(params, (tokens, tokens), cfg)
    return int(counter.get_total_flops())


def seeded_inputs(cfg: BurninConfig, dev: torch.device
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Tuple[torch.Tensor, torch.Tensor]]:
    """Parameters from a generator seeded 0 on ``dev``, tokens from one
    seeded 1, ``targets = roll(tokens, -1)``."""
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    return params, (tokens, torch.roll(tokens, -1, dims=1))


def param_specs() -> Dict[str, Tuple[Optional[str], Optional[str]]]:
    """Megatron-style TP layout, the reference's table key for key
    (``burnin.py:114-126``): per parameter, which of its two dimensions
    splits over the ``"model"`` axis. Attention and FFN first products
    column-split, second row-split; embedding and LM head split by
    vocabulary."""
    return {
        "embed": ("model", None),
        "wq": (None, "model"),
        "wk": (None, "model"),
        "wv": (None, "model"),
        "wo": ("model", None),
        "w1": (None, "model"),
        "w2": ("model", None),
        "out": (None, "model"),
    }


def make_mesh(shape: Tuple[int, int], device: DeviceLike = None):
    """A ``("data", "model")`` device mesh of ``shape = (dp, tp)`` over the
    default process group, one rank a device (``torch.distributed``'s
    ``DeviceMesh``; rank ``r`` at ``(r // tp, r % tp)``). The group must be
    up (``collectives.process_group``, ``collectives.run_ranks`` or
    ``multihost.initialize``) and the mesh must span all of it: torch has
    no devices outside a mesh to leave idle, as the reference's
    ``devices[:dp * tp]`` does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dp, tp = shape
    have = dist.get_world_size() if dist.is_initialized() else 0
    if dp * tp > have:
        # Name the axis that cannot fit: "model" when TP alone exceeds the
        # device count (no DP split can save it), "data" otherwise (the
        # residual dp = n // tp is what overshot).
        axis = "model" if tp > have else "data"
        raise ValueError(
            f"mesh (data={dp}, model={tp}) needs {dp * tp} devices, have "
            f"{have} — the '{axis}' axis is the one to shrink")
    if dp * tp != have:
        raise ValueError(
            f"mesh (data={dp}, model={tp}) covers {dp * tp} of the process "
            f"group's {have} ranks; a mesh spans the whole group")
    return init_device_mesh(resolve_device(device).type, (dp, tp),
                            mesh_dim_names=("data", "model"))


def default_mesh_shape(n: int) -> Tuple[int, int]:
    """DP x TP factorisation, the reference's rule: prefer TP up to 4, DP
    with the rest."""
    for tp in (4, 2, 1):
        if n % tp == 0 and tp <= n:
            return (n // tp, tp)
    return (n, 1)


def _check_split(cfg: BurninConfig, dp: int, tp: int) -> None:
    """Every split is whole: heads, FFN width and vocabulary over
    ``"model"``, the batch over ``"data"``. GSPMD would reshard a ragged
    split; the port raises, naming the axis."""
    for name, size in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                       ("vocab", cfg.vocab)):
        if size % tp:
            raise ValueError(f"{name}={size} does not split over the "
                             f"'model' axis of size {tp}")
    if cfg.batch % dp:
        raise ValueError(f"batch={cfg.batch} does not split over the "
                         f"'data' axis of size {dp}")


def shard_params(params: Dict[str, torch.Tensor], rank: int, size: int
                 ) -> Dict[str, torch.Tensor]:
    """The model-axis rank ``rank``'s shard of every full parameter, by
    :func:`param_specs` (contiguous slices; with ``size`` 1 the full
    tensors)."""
    out = {}
    for name, spec in param_specs().items():
        p = params[name]
        dim = spec.index("model")
        width = p.shape[dim] // size
        out[name] = p.narrow(dim, rank * width, width).contiguous()
    return out


def _global_init(mesh, cfg: BurninConfig):
    """This rank's parameters and batch. Every rank builds the full
    parameters and batch of :func:`seeded_inputs` (generators seeded 0 and
    1, as ``train_step``'s callers use) and keeps its shard: its
    ``"model"`` slice of each parameter and its ``"data"`` rows of the
    batch. So every mesh starts from the same numbers. (The reference
    initialises inside ``jit`` with sharded outputs; the full tensors here
    are transient.)"""
    params, batch = seeded_inputs(cfg, torch.device(mesh.device_type))
    local = shard_params(params, mesh.get_local_rank("model"),
                         mesh["model"].size())
    return local, data_rows(batch, mesh)


def data_rows(batch: Tuple[torch.Tensor, ...], mesh
              ) -> Tuple[torch.Tensor, ...]:
    """This rank's ``"data"`` rows of every tensor of the global
    ``batch``."""
    rows = batch[0].shape[0] // mesh["data"].size()
    start = mesh.get_local_rank("data") * rows
    return tuple(x[start:start + rows].contiguous() for x in batch)


def make_sharded_step(mesh, cfg: BurninConfig):
    """``(step, params, batch)`` on this rank of ``mesh``
    (:func:`make_mesh`): parameters split over ``"model"`` by
    :func:`param_specs`, the batch over ``"data"`` (see
    :func:`_global_init`).

    ``step(params, batch) -> (new_params, loss)``: the loss is the mean
    over the global batch, the same on every rank; each rank's gradients
    are its shards of the global loss's gradients (the model axis's
    collectives, :mod:`.tensor_parallel`), mean-all-reduced over
    ``"data"`` in f32; then :func:`sgd_update`, as in ``train_step``. The
    remat knobs act as in ``train_step``. At mesh (1, 1) no collective runs and the
    step computes what ``train_step`` does."""
    import torch.distributed as dist

    dp, tp = mesh["data"].size(), mesh["model"].size()
    _check_split(cfg, dp, tp)
    local, mine = _global_init(mesh, cfg)
    axis = (ModelAxis(mesh["model"].get_group(),
                      mesh.get_local_rank("model"), tp) if tp > 1 else None)
    data = mesh["data"].get_group() if dp > 1 else None

    def step(p, b):
        loss, grads = loss_and_grads(p, b, cfg, axis)
        if data is not None:
            # one flat f32 all-reduce of the loss and every gradient
            flat = torch.cat([loss.float().reshape(1)]
                             + [g.float().reshape(-1) for g in grads.values()])
            dist.all_reduce(flat, group=data)
            flat.div_(dp)
            loss = flat[0]
            sizes = [g.numel() for g in grads.values()]
            grads = {name: part.view(g.shape) for (name, g), part in zip(
                grads.items(), flat[1:].split(sizes))}
        return sgd_update(p, grads, cfg.lr), loss

    return step, local, mine


def timed_steps(cfg: BurninConfig, steps: int = 20, reps: int = 5,
                device: DeviceLike = None, mesh=None) -> Dict[str, Any]:
    """Training-step throughput by the shared two-point estimator: the
    counterpart of the reference's ``timed_steps`` (``burnin.py:556-684``),
    with its result keys. Without ``mesh``, :func:`train_step` on one
    device, which needs no process group (the timed drive of a caller
    that has none up); with one (:func:`make_mesh`), this rank's
    :func:`make_sharded_step` (every rank of the mesh calls this).

    A run is ``n`` steps from the same initial parameters (as the
    reference's non-donated ones), ending in a fetch of the last step's
    loss to the host, which is the sync (on every rank). The reference
    runs its steps inside one ``lax.scan`` so that per-step dispatch
    cannot swamp them; here each step is dispatched from Python, and the
    dispatch and fetch constants cancel in each pair's delta. One warm-up
    pair (kernel builds, allocator) runs first and is not timed; then
    ``reps`` pairs of ``steps`` and ``3 * steps`` steps, each run inside
    :func:`runtime_metrics.device_busy` and followed by
    :func:`runtime_metrics.add_flops` of this device's share of its FLOPs;
    then :func:`timing.paired_two_point`.

    FLOPs per step come from :func:`flops_per_step` of ``cfg``, whose
    batch is the global one: model work, remat and attention path aside,
    whatever the mesh. So ``flops_scope`` is always ``"global"``; the
    reference rescales XLA's per-device count of a sharded executable
    instead (``per_device_x<n>``).
    """
    flops = flops_per_step(cfg)
    if mesh is None:
        dev = resolve_device(device)
        params, batch = seeded_inputs(cfg, dev)
        ranks = 1

        def step(p, b):
            return train_step(p, b, cfg)
    else:
        step, params, batch = make_sharded_step(mesh, cfg)
        ranks = mesh.size()

    def run_once(n: int, record: bool = True) -> float:
        ctx = runtime_metrics.device_busy() if record \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            p = params
            for _ in range(n):
                p, loss = step(p, batch)
            float(loss)  # the sync
        elapsed = time.perf_counter() - t0
        if record:
            runtime_metrics.add_flops(flops * n / ranks)
        return elapsed

    run_once(steps, record=False), run_once(3 * steps, record=False)
    pairs = [(run_once(steps), run_once(3 * steps)) for _ in range(reps)]
    extra_steps = 2 * steps
    est = timing.paired_two_point(pairs, flops * extra_steps,
                                  flops * 3 * steps)
    timed_span = est["delta_s"]
    # tokens/s over the span the rate was computed on: the delta's extra
    # steps normally, the full long run in the degenerate fallback
    span_steps = extra_steps if "spread" in est else 3 * steps
    out: Dict[str, Any] = {
        "steps": steps,
        "seconds": timed_span,
        "flops_per_step": float(flops),
        "flops_scope": "global",
        "estimator": est["estimator"],
        "reps": reps,
        "points": [{"steps": steps, "seconds": round(est["lo_s"], 4)},
                   {"steps": 3 * steps, "seconds": round(est["hi_s"], 4)}],
        "tflops": est["tflops"] if flops else 0.0,
        "tokens_per_s": (cfg.batch * cfg.seq * span_steps / timed_span
                         if timed_span > 0 else 0.0),
    }
    if "spread" in est:
        out["tflops_spread"] = est["spread"]
    if "note" in est:
        out["note"] = est["note"]
    return out


def run(steps: int = 5, cfg: BurninConfig = BurninConfig(),
        device: DeviceLike = None, publish_interval_s: float = 5.0,
        mesh_shape: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` SGD steps through
    :func:`make_sharded_step` on a ``mesh_shape`` mesh (default
    :func:`default_mesh_shape` of the group's size) over the current
    process group, or over a one-rank group of ``device`` when none is up:
    the counterpart of the reference's ``run`` (``burnin.py:687-735``),
    with its result keys. ``devices`` and ``processes`` are the group's
    ranks (one process a device).

    Parameters come from a ``torch.Generator`` seeded 0 on the device,
    tokens from one seeded 1, ``targets = roll(tokens, -1)``; each rank
    keeps its shard. Every step fetches its loss to the host, which is
    the sync; each step after the first (which carries the kernel builds
    and warm-up) runs under :func:`runtime_metrics.device_busy`. After
    every synced step this device's share of :func:`flops_per_step` goes
    to :func:`runtime_metrics.add_flops`; the metrics textfile is written
    every ``publish_interval_s`` seconds and once at the end (a no-op
    without the exporter's hostPath)."""
    from . import collectives

    flops = flops_per_step(cfg)
    with collectives.process_group(device) as (_, world, dev):
        shape = tuple(mesh_shape or default_mesh_shape(world))
        mesh = make_mesh(shape, dev)
        step, params, batch = make_sharded_step(mesh, cfg)
        losses = []
        metrics_path = runtime_metrics.resolved_path()
        t0 = time.perf_counter()
        last_publish = time.monotonic()
        for i in range(steps):
            ctx = runtime_metrics.device_busy() if i \
                else contextlib.nullcontext()
            with ctx:
                params, loss = step(params, batch)
                losses.append(float(loss))
            runtime_metrics.add_flops(flops / world)
            # periodic mid-run publication: a scraper during a long
            # burn-in sees live gauges, not only the end-of-Job snapshot
            now = time.monotonic()
            if now - last_publish >= publish_interval_s:
                runtime_metrics.write(metrics_path)
                last_publish = now
        # final snapshot: a run shorter than the interval still publishes
        runtime_metrics.write(metrics_path)
        dt = time.perf_counter() - t0
    decreasing = losses[-1] < losses[0]
    return {
        "check": "burnin", "mesh": {"data": shape[0], "model": shape[1]},
        "devices": world, "processes": world,
        "steps": steps, "losses": [round(l, 4) for l in losses],
        "seconds": dt, "loss_decreasing": bool(decreasing),
        "ok": bool(decreasing and np.isfinite(losses).all()),
    }


if __name__ == "__main__":
    import json
    print(json.dumps(run(), indent=2))
