"""Decode attention: one query row a (slot, head) over that slot's cached
keys and values. The hand-written Hopper kernel, its plain version and
the wrapper that the serving engine's decode step calls.

The kernel, CUDA C++ for ``sm_90a`` in ``tpu_cluster_torch/csrc/
decode_attn.cu``, replaces no TPU kernel. The JAX package's engine
recomputes the whole ``[slots, seq]`` buffer every decode iteration and
runs the flash forward (K1) over every query row; the port keeps each
slot's keys and values on the card (``workloads/serving.py``,
``make_decode``) and attends one new row a slot, with this kernel where
K1 ran. Its head note says what bounds it (bytes) and what its design
does about that: keys split into chunks of one size so that the grid
fills the card evenly, ``cp.async`` loads into a ring of stages, f32
products on the CUDA cores, the chunks merged by their log-sum-exp in a
second short pass.

Tensors: ``q`` bf16 ``[slots, H, D]``; the caches ``k`` and ``v`` bf16
``[slots, seq, H, D]`` (any slot, seq and head strides, D contiguous);
``lengths`` int32 ``[slots]``, slot s attending keys ``0 .. lengths[s] -
1``, and the same lengths on the host, which size the chunks without a
sync. The result is bf16 ``[slots, H, D]``.

CUDA tensors launch the kernel (on the current stream, without a
synchronise) or raise; CPU tensors take :func:`decode_attention_reference`,
which the engine also runs directly on the CPU and at head widths the
kernel is not built for. ``decode_attention.launches`` counts the
kernel's launches (a split pass and its merge a launch).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import _build

# Head widths the kernel is instantiated for (those of K1).
SUPPORTED_HEAD_DIMS = (128, 256)
# The fewest keys a chunk takes: below that a block's pipeline barely
# fills before it drains.
MIN_CHUNK_KEYS = 256
# Blocks the grid aims at, in multiples of what the SMs hold at once:
# several, so that the chunks' partly empty tails and uneven slots even out.
WAVES = 4

_NAME = "decode_attn"


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor,
                               sm_scale: float) -> torch.Tensor:
    """The plain version of the kernel, with its arithmetic: f32 scores
    (the product of the up-cast bf16 operands) times ``sm_scale`` over
    keys ``0 .. lengths[s] - 1``, the softmax in f32, P V over the up-cast
    values in f32, the result rounded once to q's dtype. Runs on any
    device; only the rows ``k.shape[1]`` holds are read, so a caller that
    knows the longest length passes the caches cut to it."""
    seq = k.shape[1]
    scores = torch.einsum("shd,skhd->shk", q.float(), k.float()) * sm_scale
    past = (torch.arange(seq, device=q.device)[None, :]
            >= lengths.to(device=q.device, dtype=torch.long)[:, None])
    probs = torch.softmax(scores.masked_fill_(past[:, None, :],
                                              float("-inf")), dim=-1)
    return torch.einsum("shk,skhd->shd", probs, v.float()).to(q.dtype)


def chunk_keys(lengths: Sequence[int], heads: int, sms: int, per_sm: int,
               tile: int) -> int:
    """Keys a chunk of the kernel takes: every (slot, head)'s keys, cut
    into chunks of this size, make about ``WAVES`` times the blocks that
    ``sms`` SMs holding ``per_sm`` each run at once; whole ``tile``s, and
    no fewer than ``MIN_CHUNK_KEYS``."""
    want = -(-heads * sum(lengths) // (WAVES * sms * per_sm))
    return -(-max(want, MIN_CHUNK_KEYS) // tile) * tile


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take, on every
    device, before any launch."""
    if q.dim() != 3:
        raise ValueError(f"q must be [slots, H, D], got {tuple(q.shape)}")
    slots, heads, head_dim = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.dim() != 4 or x.shape[0] != slots or x.shape[2:] != q.shape[1:]:
            raise ValueError(f"{name} must be [slots, seq, H, D] = "
                             f"[{slots}, seq, {heads}, {head_dim}], got "
                             f"{tuple(x.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not supported; the kernel "
                         f"takes {SUPPORTED_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, x in (("k", k), ("v", v)):
        # cp.async moves 16-byte pieces of each row
        if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} rows must be contiguous in D and "
                             f"start 16-byte aligned (strides {x.stride()})")
    if tuple(lengths.shape) != (slots,) or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous() or lengths.device != q.device:
        raise ValueError(f"lengths must be contiguous int32 [{slots}] on "
                         f"{q.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if lib.decode_attn.argtypes is None:
        lib.decode_attn.argtypes = ([ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 5
                                    + [ctypes.c_int64] * 6
                                    + [ctypes.c_float, ctypes.c_void_p])
        lib.decode_attn.restype = ctypes.c_int
        for name in ("decode_attn_blocks_per_sm", "decode_attn_tile_keys"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        lib.decode_attn_error_string.argtypes = [ctypes.c_int]
        lib.decode_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, head_dim: int) -> Tuple[int, int, int]:
    """(SMs of CUDA device ``index``, split-pass blocks an SM holds at
    ``head_dim``, keys a stage holds): facts of the card and the build,
    asked once."""
    lib = _lib()
    with torch.cuda.device(index):
        per_sm = lib.decode_attn_blocks_per_sm(head_dim)
    if per_sm <= 0:
        raise RuntimeError(f"{_NAME}: no block fits an SM at head_dim "
                           f"{head_dim}")
    return (torch.cuda.get_device_properties(index).multi_processor_count,
            per_sm, lib.decode_attn_tile_keys(head_dim))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, sm_scale: float,
                     host_lengths: Sequence[int]) -> torch.Tensor:
    """softmax(q K^T * sm_scale) V for each slot's one query row over its
    first ``lengths[s]`` cached keys and values: a new contiguous bf16
    ``[slots, H, D]`` tensor. ``host_lengths``, the same lengths on the
    host, size the chunks (:func:`chunk_keys`) without a sync. CUDA
    tensors launch the kernel or raise; CPU tensors take
    :func:`decode_attention_reference`. Not differentiable."""
    _check(q, k, v, lengths)
    slots, heads, head_dim = q.shape
    lens = [int(n) for n in host_lengths]
    if len(lens) != slots or not all(1 <= n <= k.shape[1] for n in lens):
        raise ValueError(f"host_lengths {lens} are not {slots} lengths in "
                         f"[1, {k.shape[1]}]")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    keys = chunk_keys(lens, heads, *_occupancy(index, head_dim))
    chunks = -(-max(lens) // keys)
    out = torch.empty_like(q)
    o_part = torch.empty((slots, heads, chunks, head_dim),
                         dtype=torch.float32, device=q.device)
    ml_part = torch.empty((slots, heads, chunks, 2), dtype=torch.float32,
                          device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(), slots,
            heads, head_dim, chunks, keys, *k.stride()[:3], *v.stride()[:3],
            float(sm_scale), stream)
    if err != 0:
        msg = lib.decode_attn_error_string(err).decode()
        raise RuntimeError(f"{_NAME} launch failed: {msg} ({err})")
    decode_attention.launches += 1  # type: ignore[attr-defined]
    return out


decode_attention.launches = 0  # type: ignore[attr-defined]
