"""Causal flash attention, forward and backward: the Hopper kernels, their
plain versions, the wrappers and the autograd Function the model calls.
Every entry takes ``window``: 0 is causal attention, ``window > 0`` lets
query i see key j iff ``0 <= i - j < window`` (a sliding window, as a
Hugging Face ``sliding_window`` layer has it).

Three kernels, CUDA C++ for ``sm_90a`` under ``tpu_cluster_torch/csrc``,
replace the three TPU kernels of upstream JAX's
``jax/experimental/pallas/ops/tpu/flash_attention.py`` that
``tpu_cluster/workloads/burnin.py:220-227`` reaches from ``forward`` with
``attention="flash"`` (and, for the backward, from ``loss_fn`` and
``train_step``, which differentiate it):

- K1, ``flash_attn_fwd.cu`` for ``_flash_attention_impl``: O, and for
  training the row logsumexp ``lse`` (upstream saves the row max m and
  denominator l; ``lse = m + log l``);
- K2, ``flash_attn_bwd_dkv.cu`` for ``_flash_attention_bwd_dkv``: dK, dV;
- K3, ``flash_attn_bwd_dq.cu`` for ``_flash_attention_bwd_dq``: dQ.

All three are warp-specialised Hopper kernels: a producer warpgroup
issues TMA loads into rings of shared-memory stages, two consumer
warpgroups run ``wgmma`` products (``csrc/hopper_common.cuh``). All
three take bf16 operands with f32 accumulation; the [S, S] scores never
reach device memory. Each source's head note says what bounds it on an
H100 and what its design leaves on the table. ``di = rowsum(o * dO)`` in f32 is plain torch between the
forward and the backward kernels, as upstream computes it in XLA outside
any ``pallas_call``.

Tensors are ``[B, S, H, D]``, the layout ``burnin.forward`` produces; the
kernels take their strides, so no transpose copies are made. ``lse`` and
``di`` are contiguous f32 ``[B, H, S]``.

CUDA tensors launch the kernels (on the current stream, without a
synchronise) or raise; CPU tensors take the plain versions, which repeat
the kernels' arithmetic. Each wrapper counts its launches in
``.launches``: :func:`flash_attention` (and :func:`flash_attention_with_lse`)
for K1, :func:`flash_attention_bwd_dkv` for K2, :func:`flash_attention_bwd_dq`
for K3.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

# S must be a multiple of it: the query and key tiles of K2 and K3, and
# half of K1's 128-row query tile (whose rows past S load as zeros).
BLOCK = 64
# Head widths the kernels are instantiated for (the reference selector's
# d_head % 128 == 0, at the widths the repo's configurations use).
SUPPORTED_HEAD_DIMS = (128, 256)

# Per C entry point: bf16/f32 tensor pointers, then tensors with strides
# (the dims, the strides, sm_scale, the stream and the window around them).
_SIGNATURES = {
    "flash_attn_fwd": (5, 4),
    "flash_attn_bwd_dkv": (8, 6),
    "flash_attn_bwd_dq": (7, 5),
}


def _causal_scores(q: torch.Tensor, k: torch.Tensor, sm_scale: float,
                   window: int = 0) -> torch.Tensor:
    """f32 ``[B, H, S, S]`` scaled scores (the product of the up-cast
    inputs, exact for bf16 operands) with -inf above the diagonal and,
    with a ``window``, at and below its edge (``i - j >= window``)."""
    seq = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores.mul_(sm_scale)
    out = torch.ones(seq, seq, dtype=torch.bool, device=q.device).triu_(1)
    if window:
        out |= torch.ones(seq, seq, dtype=torch.bool,
                          device=q.device).tril_(-window)
    return scores.masked_fill_(out, float("-inf"))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, sm_scale: float,
                              return_lse: bool = False, window: int = 0):
    """The plain version of K1: causal (or ``window``ed) softmax(Q K^T *
    sm_scale) V over ``[B, S, H, D]`` tensors, with the arithmetic of the
    kernel. Scores
    and softmax statistics are f32; P = exp(s - max) is rounded to the
    input dtype before P V, which accumulates in f32; the result is divided
    by the f32 row sum and returned in the input dtype. With
    ``return_lse`` it also returns the f32 ``[B, H, S]`` row logsumexp
    ``max + log(sum)`` of the scaled scores. It materialises the
    [B, H, S, S] scores, so at long S callers pass a few heads or one
    batch row at a time."""
    scores = _causal_scores(q, k, sm_scale, window)
    row_max = scores.amax(-1, keepdim=True)
    p = scores.sub_(row_max).exp_()
    denom = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v.float())
    out = (out / denom).to(q.dtype).transpose(1, 2).contiguous()
    if not return_lse:
        return out
    return out, (row_max + denom.log()).squeeze(-1)


def _probs(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
           sm_scale: float, window: int = 0) -> torch.Tensor:
    """f32 ``[B, H, S, S]`` P = exp(s - lse), zero where masked."""
    return _causal_scores(q, k, sm_scale, window).sub_(
        lse[..., None]).exp_()


def _dscores(p: torch.Tensor, do: torch.Tensor, v: torch.Tensor,
             di: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """f32 ``[B, H, S, S]`` dS = P (dO V^T - di) sm_scale."""
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return dp.sub_(di[..., None]).mul_(p).mul_(sm_scale)


def flash_attention_bwd_dkv_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        lse: torch.Tensor, di: torch.Tensor, sm_scale: float,
        window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K2, with the kernel's (and upstream's)
    arithmetic: P = exp(s - lse) in f32; dV = bf16(P)^T dO; dS =
    P (dO V^T - di) sm_scale in f32; dK = bf16(dS)^T Q; products of the
    up-cast bf16 operands summed in f32, results in the input dtype,
    ``[B, S, H, D]``. Materialises several f32 [B, H, S, S] tensors."""
    dt = q.dtype
    p = _probs(q, k, lse, sm_scale, window)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    ds = _dscores(p, do, v, di, sm_scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dt).float(), q.float())
    return dk.to(dt).contiguous(), dv.to(dt).contiguous()


def flash_attention_bwd_dq_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        lse: torch.Tensor, di: torch.Tensor, sm_scale: float,
        window: int = 0) -> torch.Tensor:
    """The plain version of K3: dS as in
    :func:`flash_attention_bwd_dkv_reference`, then dQ = bf16(dS) K summed
    in f32, ``[B, S, H, D]`` in the input dtype."""
    dt = q.dtype
    ds = _dscores(_probs(q, k, lse, sm_scale, window), do, v, di, sm_scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(dt).float(), k.float())
    return dq.to(dt).contiguous()


def _rows_aligned(x: torch.Tensor) -> bool:
    """TMA (K1, K2, K3) moves 16-byte units: D contiguous, the base and
    every stride 16-byte aligned."""
    return (x.stride(3) == 1 and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           do: Optional[torch.Tensor] = None, window: int = 0) -> None:
    """Raise ValueError on anything the kernels do not take, on every
    device, before any launch."""
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")
    named = [("q", q), ("k", k), ("v", v)] + ([("do", do)] if do is not None
                                              else [])
    if q.dim() != 4 or any(x.shape != q.shape for _, x in named):
        raise ValueError(f"{', '.join(n for n, _ in named)} must share one "
                         f"[B, S, H, D] shape; got "
                         f"{', '.join(str(tuple(x.shape)) for _, x in named)}")
    _, seq, _, head_dim = q.shape
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not supported; the kernel "
                         f"takes {SUPPORTED_HEAD_DIMS}")
    if seq == 0 or seq % BLOCK != 0:
        raise ValueError(f"seq {seq} must be a positive multiple of {BLOCK}")
    for name, x in named:
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in D")
        if not _rows_aligned(x):
            raise ValueError(f"{name} rows must start 16-byte aligned "
                             f"(strides {x.stride()})")


def _check_rows(q: torch.Tensor, **stats: torch.Tensor) -> None:
    """lse and di: contiguous f32 [B, H, S] on q's device."""
    batch, seq, heads, _ = q.shape
    for name, x in stats.items():
        if tuple(x.shape) != (batch, heads, seq):
            raise ValueError(f"{name} must be [B, H, S] = "
                             f"{(batch, heads, seq)}, got {tuple(x.shape)}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _on_cpu(q: torch.Tensor, name: str) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return False


def _launch(name: str, tensors, dims, strided, sm_scale: float,
            window: int) -> None:
    """Call the C entry point ``name`` of ``csrc/<name>.cu`` on the current
    stream with the tensors' pointers, the dims, the (batch, seq, head)
    strides of ``strided`` and the window; raise on a non-zero
    cudaError_t."""
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptr, n_strided = _SIGNATURES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * (3 * n_strided)
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    device = tensors[0].device
    strides = [s for x in strided for s in x.stride()[:3]]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(0 if x is None else x.data_ptr() for x in tensors),
                 *dims, *strides, float(sm_scale), stream, window)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             sm_scale: float, with_lse: bool, window: int = 0):
    """K1 on checked inputs: (o, lse or None)."""
    if _on_cpu(q, "flash_attention"):
        if with_lse:
            return flash_attention_reference(q, k, v, sm_scale, True, window)
        return flash_attention_reference(q, k, v, sm_scale,
                                         window=window), None
    batch, seq, heads, head_dim = q.shape
    out = torch.empty((batch, seq, heads, head_dim), dtype=q.dtype,
                      device=q.device)
    lse = (torch.empty((batch, heads, seq), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    _launch("flash_attn_fwd", (q, k, v, out, lse),
            (batch, seq, heads, head_dim), (q, k, v, out), sm_scale, window)
    flash_attention.launches += 1  # type: ignore[attr-defined]
    return out, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, sm_scale: float,
                             window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 with its training residual: ``(o, lse)``, o a new contiguous
    bf16 ``[B, S, H, D]`` tensor and lse the f32 ``[B, H, S]`` row
    logsumexp of the scaled scores. Not differentiable; counts on
    ``flash_attention.launches``."""
    _check(q, k, v, window=window)
    return _forward(q, k, v, sm_scale, True, window)


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, di: torch.Tensor,
                            sm_scale: float, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(dk, dv)``, new contiguous bf16 ``[B, S, H, D]`` tensors, from
    bf16 q, k, v, dO and f32 ``[B, H, S]`` lse (K1's) and di =
    rowsum(o * dO). CUDA tensors launch the kernel or raise; CPU tensors
    take :func:`flash_attention_bwd_dkv_reference`."""
    _check(q, k, v, do, window)
    _check_rows(q, lse=lse, di=di)
    if _on_cpu(q, "flash_attention_bwd_dkv"):
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, di,
                                                 sm_scale, window)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_attn_bwd_dkv", (q, k, v, do, lse, di, dk, dv),
            tuple(q.shape), (q, k, v, do, dk, dv), sm_scale, window)
    flash_attention_bwd_dkv.launches += 1  # type: ignore[attr-defined]
    return dk, dv


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, di: torch.Tensor,
                           sm_scale: float, window: int = 0) -> torch.Tensor:
    """K3: dq, a new contiguous bf16 ``[B, S, H, D]`` tensor, from the same
    inputs as :func:`flash_attention_bwd_dkv`. CUDA tensors launch the
    kernel or raise; CPU tensors take
    :func:`flash_attention_bwd_dq_reference`."""
    _check(q, k, v, do, window)
    _check_rows(q, lse=lse, di=di)
    if _on_cpu(q, "flash_attention_bwd_dq"):
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, di,
                                                sm_scale, window)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("flash_attn_bwd_dq", (q, k, v, do, lse, di, dq),
            tuple(q.shape), (q, k, v, do, dq), sm_scale, window)
    flash_attention_bwd_dq.launches += 1  # type: ignore[attr-defined]
    return dq


class _FlashAttention(torch.autograd.Function):
    """Forward K1 with lse; backward di in plain torch, then K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, window):  # type: ignore[override]
        out, lse = _forward(q, k, v, sm_scale, True, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.window = sm_scale, window
        return out

    @staticmethod
    def backward(ctx, do):  # type: ignore[override]
        q, k, v, out, lse = ctx.saved_tensors
        if not _rows_aligned(do):
            do = do.contiguous()  # the kernels read rows by TMA
        # di = rowsum(o * dO) over D in f32 from the bf16 o and dO, as
        # upstream's _flash_attention_bwd: [B, S, H] -> [B, H, S]
        di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, ctx.sm_scale,
                                         ctx.window)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, di, ctx.sm_scale,
                                    ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, window: int = 0) -> torch.Tensor:
    """Causal attention over bf16 ``[B, S, H, D]`` tensors (with a
    ``window``, each query over its last ``window`` keys, itself included),
    returned as a new contiguous bf16 ``[B, S, H, D]`` tensor;
    differentiable in q, k and v.

    When autograd records (grad enabled and an input requires grad) the
    forward is K1 with its lse residual and the backward runs K2 and K3;
    otherwise K1 alone, writing no lse. CUDA tensors launch the kernels
    (on the current stream, without a synchronise) or raise; CPU tensors
    take the plain versions. ``flash_attention.launches`` counts K1's
    launches."""
    _check(q, k, v, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, sm_scale, window)
    return _forward(q, k, v, sm_scale, False, window)[0]


flash_attention.launches = 0  # type: ignore[attr-defined]
flash_attention_bwd_dkv.launches = 0  # type: ignore[attr-defined]
flash_attention_bwd_dq.launches = 0  # type: ignore[attr-defined]
