"""Causal flash-attention forward: the Hopper kernel, its plain version
and the wrapper the model calls.

Replaces the TPU kernel upstream JAX's
``jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_impl``
(its ``pl.pallas_call``), which ``tpu_cluster/workloads/burnin.py:220-227``
reaches from ``forward`` with ``attention="flash"``. The kernel,
``tpu_cluster_torch/csrc/flash_attn_fwd.cu``, is CUDA C++ for ``sm_90a``:
one CTA per (64-row query tile, head, batch), a loop over the KV tiles
(32 keys at D = 256, 64 at D = 128) up to the causal diagonal,
``mma.sync`` bf16 tensor-core products with f32 accumulation, and an
online softmax with f32 running max and denominator. The [S, S] scores never reach device memory.

Bound at the serving shape (B4 H16 S8192 D256, bf16) on an H100 SXM: the
causal useful work is 2*B*H*S^2*D = 2.20 TFLOP, 2.22 ms at the card's
989 TFLOP/s dense bf16; the bytes (q, k, v read once, o written once:
4 x 268 MB = 1.07 GB) take 0.32 ms at 3.35 TB/s. It is compute-bound.
The simple design leaves on the table: ``wgmma`` (it uses ``mma.sync``),
TMA (it copies with per-thread ``cp.async``), and overlap between copies
and compute beyond one tile of prefetch (no warp specialisation, single
buffers).

Tensors are ``[B, S, H, D]``, the layout ``burnin.forward`` produces; the
kernel takes their strides, so no transpose copies are made.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Query rows per CTA of the kernel (a multiple of its KV tile): S must be
# a multiple of it.
BLOCK = 64
# Head widths the kernel is instantiated for (the reference selector's
# d_head % 128 == 0, at the widths the repo's configurations use).
SUPPORTED_HEAD_DIMS = (128, 256)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """The plain version: causal softmax(Q K^T * sm_scale) V over
    ``[B, S, H, D]`` tensors, with the arithmetic of the kernel. Scores
    and softmax statistics are f32 (the product of the up-cast inputs,
    exact for bf16 operands); P = exp(s - max) is rounded to the input
    dtype before P V, which accumulates in f32; the result is divided by
    the f32 row sum and returned in the input dtype. It materialises the
    [B, H, S, S] scores, so at long S callers pass one batch row at a
    time."""
    seq = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores.mul_(sm_scale)
    above = torch.ones(seq, seq, dtype=torch.bool, device=q.device).triu_(1)
    scores.masked_fill_(above, float("-inf"))
    p = scores.sub_(scores.amax(-1, keepdim=True)).exp_()
    denom = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v.float())
    return (out / denom).to(q.dtype).transpose(1, 2).contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take, on every
    device, before any launch."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, S, H, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _, seq, _, head_dim = q.shape
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not supported; the kernel "
                         f"takes {SUPPORTED_HEAD_DIMS}")
    if seq == 0 or seq % BLOCK != 0:
        raise ValueError(f"seq {seq} must be a positive multiple of {BLOCK}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in D")
        # cp.async moves 16 bytes: every row start must be 16-byte aligned
        if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} rows must start 16-byte aligned "
                             f"(strides {x.stride()})")


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Causal attention over bf16 ``[B, S, H, D]`` tensors, returned as a
    new contiguous bf16 ``[B, S, H, D]`` tensor.

    CUDA tensors launch the kernel (on the current stream, without a
    synchronise) or raise; CPU tensors take
    :func:`flash_attention_reference`. ``flash_attention.launches``
    counts kernel launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    lib = _library()
    batch, seq, heads, head_dim = q.shape
    out = torch.empty((batch, seq, heads, head_dim), dtype=q.dtype,
                      device=q.device)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), batch, seq, heads, head_dim,
                                 *strides, float(sm_scale), stream)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attn_fwd launch failed: {msg} ({err})")
    flash_attention.launches += 1  # type: ignore[attr-defined]
    return out


flash_attention.launches = 0  # type: ignore[attr-defined]
