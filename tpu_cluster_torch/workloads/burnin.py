"""The burn-in transformer block in PyTorch: serving and single-card
training.

Port of ``tpu_cluster/workloads/burnin.py``: the same configuration,
parameters (shapes, scales, dtypes, ``[in, out]`` layout so ``y @ W``
reads the same in both packages), forward numerics, fused cross-entropy,
remat policies, SGD step and ``run``, on a torch device.
``attention="flash"`` runs the hand-written Hopper kernels
(:mod:`tpu_cluster_torch.kernels.flash_attention`: K1 forward, K2 and K3
backward) on CUDA tensors and their plain versions on CPU tensors.

``python -m tpu_cluster_torch.workloads.burnin`` trains the default
configuration for 5 steps on the card and prints ``run``'s JSON.
:func:`timed_steps` measures training throughput with the shared
two-point estimator, against the model FLOPs of :func:`flops_per_step`.

Not ported yet: the mesh, ``param_specs`` and ``make_sharded_step``
(sharded training).

Matrix-product precision is pinned at import for the whole process:
float32 products run in full float32 (no TF32), and bf16 products reduce
in full precision, so the f32 score and LM-head products below are the
exact-product f32 sums the reference's ``preferred_element_type=f32``
asks for.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)
from torch.utils.flop_counter import FlopCounterMode

from . import runtime_metrics, timing
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


def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: BurninConfig) -> torch.Tensor:
    """One pre-norm transformer block + LM head: bf16 compute, f32
    ``[B, S, vocab]`` logits. ``tokens`` is an integer ``[B, S]`` tensor
    on the parameters' device."""
    _check_knobs(cfg)
    bf16 = torch.bfloat16
    x = params["embed"][tokens.long()].to(bf16)            # [B, S, D]
    h = cfg.n_heads
    d_head = cfg.d_model // h
    shape = (*x.shape[:2], h, d_head)

    y = _rms(x)
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
    x = x + o.reshape(x.shape) @ params["wo"].to(bf16)
    y = _rms(x)
    ff = F.gelu(y @ params["w1"].to(bf16), approximate="tanh")
    x = x + ff @ params["w2"].to(bf16)
    # LM head: f32 product of the up-cast bf16 operands (exact products,
    # f32 sums), never rounded to bf16
    return _rms(x).float() @ params["out"].to(bf16).float()


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
# dispatches to aten.mm); the attention products carry batch and head
# dimensions (aten.bmm) and are recomputed, as is everything else.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_saveable)


def loss_fn(params: Dict[str, torch.Tensor],
            batch: Tuple[torch.Tensor, torch.Tensor],
            cfg: BurninConfig) -> torch.Tensor:
    """Mean cross-entropy of :func:`forward` on ``batch = (tokens,
    targets)``, with the reference's remat policies (``burnin.py:308-318``):
    "dots" saves only the outputs of products without batch dimensions
    (a selective ``torch.utils.checkpoint``), "full" checkpoints the whole
    forward, "attn" checkpoints the "xla" attention block inside
    :func:`forward`, anything else saves everything."""
    tokens, targets = batch
    if cfg.remat == "dots":
        logits = checkpoint(forward, params, tokens, cfg, use_reentrant=False,
                            context_fn=_save_dots)
    elif cfg.remat == "full":
        logits = checkpoint(forward, params, tokens, cfg, use_reentrant=False)
    else:
        logits = forward(params, tokens, cfg)
    return softmax_xent(logits, targets)


def loss_and_grads(params: Dict[str, torch.Tensor],
                   batch: Tuple[torch.Tensor, torch.Tensor],
                   cfg: BurninConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its gradient with respect to every parameter (each in
    its parameter's dtype); ``params`` are not modified."""
    leaves = {name: p.detach().requires_grad_() for name, p in params.items()}
    loss = loss_fn(leaves, batch, cfg)
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
    with torch.no_grad():
        new = {name: (p.float() - cfg.lr * grads[name].float()).to(p.dtype)
               for name, p in params.items()}
    return new, loss


def standard_config() -> BurninConfig:
    """Standard-geometry shape: d4096/f16384/h16 (d_head 256) is GPT-J-6B's
    block geometry, with vocab 8192, as in the reference."""
    return BurninConfig(vocab=8192, d_model=4096, d_ff=16384,
                        n_heads=16, seq=512, batch=8)


# The reference's crossover (measured there on a TPU, where the [B,H,S,S]
# "xla" path wins through s4096). It is carried over unchanged so the two
# selectors agree; the H100's own crossover is still to be measured.
FLASH_CROSSOVER_SEQ = 8192


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


def timed_steps(cfg: BurninConfig, steps: int = 20, reps: int = 5,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Training-step throughput on one device, by the shared two-point
    estimator: the counterpart of the reference's ``timed_steps``
    (``burnin.py:556-684``), with its result keys.

    A run is ``n`` calls of :func:`train_step` from the same initial
    parameters (as the reference's non-donated ones), ending in a fetch
    of the last step's loss to the host, which is the sync. The reference
    runs its steps inside one ``lax.scan`` so that per-step dispatch
    cannot swamp them; here each step is dispatched from Python, and the
    dispatch and fetch constants cancel in each pair's delta. One warm-up
    pair (kernel builds, allocator) runs first and is not timed; then
    ``reps`` pairs of ``steps`` and ``3 * steps`` steps, each run inside
    :func:`runtime_metrics.device_busy` and followed by
    :func:`runtime_metrics.add_flops` of its FLOPs; then
    :func:`timing.paired_two_point`. FLOPs per step come from
    :func:`flops_per_step` (model work, remat and attention path aside);
    one device, so ``flops_scope`` is ``"global"``.
    """
    dev = resolve_device(device)
    flops = flops_per_step(cfg)
    params, batch = seeded_inputs(cfg, dev)

    def run_once(n: int, record: bool = True) -> float:
        ctx = runtime_metrics.device_busy() if record \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            p = params
            for _ in range(n):
                p, loss = train_step(p, batch, cfg)
            float(loss)  # the sync
        elapsed = time.perf_counter() - t0
        if record:
            runtime_metrics.add_flops(flops * n)
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
        device: DeviceLike = None,
        publish_interval_s: float = 5.0) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` SGD steps on one device: the
    single-card counterpart of the reference's ``run``
    (``burnin.py:687-735``), with its result keys.

    Parameters come from a ``torch.Generator`` seeded 0 on the device,
    tokens from one seeded 1, ``targets = roll(tokens, -1)``. Every step
    fetches its loss to the host, which is the sync; each step after the
    first (which carries the kernel builds and warm-up) runs under
    :func:`runtime_metrics.device_busy`. After every synced step the
    step's :func:`flops_per_step` goes to :func:`runtime_metrics.add_flops`;
    the metrics textfile is written every ``publish_interval_s`` seconds
    and once at the end (a no-op without the exporter's hostPath). The
    mesh is one device, so ``mesh`` is ``{"data": 1, "model": 1}``."""
    dev = resolve_device(device)
    flops = flops_per_step(cfg)
    params, batch = seeded_inputs(cfg, dev)
    losses = []
    metrics_path = runtime_metrics.resolved_path()
    t0 = time.perf_counter()
    last_publish = time.monotonic()
    for i in range(steps):
        ctx = runtime_metrics.device_busy() if i else contextlib.nullcontext()
        with ctx:
            params, loss = train_step(params, batch, cfg)
            losses.append(float(loss))
        runtime_metrics.add_flops(flops)
        # periodic mid-run publication: a scraper during a long burn-in
        # sees live gauges, not only the end-of-Job snapshot
        now = time.monotonic()
        if now - last_publish >= publish_interval_s:
            runtime_metrics.write(metrics_path)
            last_publish = now
    # final snapshot: a run shorter than the interval still publishes
    runtime_metrics.write(metrics_path)
    dt = time.perf_counter() - t0
    decreasing = losses[-1] < losses[0]
    return {
        "check": "burnin", "mesh": {"data": 1, "model": 1},
        "devices": 1, "processes": 1,
        "steps": steps, "losses": [round(l, 4) for l in losses],
        "seconds": dt, "loss_decreasing": bool(decreasing),
        "ok": bool(decreasing and np.isfinite(losses).all()),
    }


if __name__ == "__main__":
    import json
    print(json.dumps(run(), indent=2))
