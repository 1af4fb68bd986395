"""Decode attention on the CPU: the plain version against a direct masked
softmax, the kernel's split-and-merge arithmetic written out in torch,
the chunk count, and the wrapper's checks. The kernel itself runs on the
card only (``tests/test_torch_decode_attention_cuda.py``)."""

import math

import pytest
import torch

from tpu_cluster_torch.kernels import decode_attention as da

SEQ = 96
# bf16 outputs against f64 sums: one rounding to bf16 (2^-9 relative at
# most) plus f32 summation order, far below it.
ATOL = 2 ** -8


def _inputs(slots, seq, heads, head_dim, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               for shape in ((slots, heads, head_dim),
                             (slots, seq, heads, head_dim),
                             (slots, seq, heads, head_dim)))
    return q, k, v


def _direct(q, k, v, lengths, scale):
    """Each slot's masked softmax in f64, one slot and head at a time."""
    out = torch.empty(q.shape, dtype=torch.float64)
    for s, n in enumerate(lengths.tolist()):
        for h in range(q.shape[1]):
            keys = k[s, :n, h].double()
            w = torch.softmax(keys @ q[s, h].double() * scale, dim=0)
            out[s, h] = w @ v[s, :n, h].double()
    return out


LENGTHS = [1, 63, 64, 65, SEQ]


@pytest.mark.parametrize("head_dim", [16, 128])
def test_plain_version_is_the_masked_softmax_at_ragged_lengths(head_dim):
    q, k, v = _inputs(len(LENGTHS), SEQ, 3, head_dim)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    scale = head_dim ** -0.5
    got = da.decode_attention_reference(q, k, v, lengths, scale)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = _direct(q, k, v, lengths, scale)
    assert (got.double() - want).abs().max().item() <= ATOL
    # length 1 is the slot's first value row, exactly
    assert torch.equal(got[0], v[0, 0])
    # rows past a slot's length are never read
    k2, v2 = k.clone(), v.clone()
    for s, n in enumerate(LENGTHS):
        k2[s, n:], v2[s, n:] = float("nan"), 1e4
    assert torch.equal(
        da.decode_attention_reference(q, k2, v2, lengths, scale), got)


def _split_and_merge(q, k, v, lengths, scale, chunk):
    """The kernel's arithmetic in torch: each slot's keys cut into runs of
    ``chunk`` keys, each run's max (base 2) and sum and unnormalised
    output, then the runs merged by their log-sum-exp."""
    out = torch.empty(q.shape, dtype=torch.float32)
    for s, n in enumerate(lengths.tolist()):
        parts = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            sc = torch.einsum("hd,khd->hk", q[s].float(),
                              k[s, lo:hi].float()) * scale * math.log2(math.e)
            m = sc.amax(-1)
            p = torch.exp2(sc - m[:, None])
            parts.append((m, p.sum(-1),
                          torch.einsum("hk,khd->hd", p, v[s, lo:hi].float())))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp2(m - mx) for m, _, _ in parts]
        total = sum(wi * l for wi, (_, l, _) in zip(w, parts))
        acc = sum(wi[:, None] * o for wi, (_, _, o) in zip(w, parts))
        out[s] = acc / total[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("chunk", [32, 64, 96, SEQ])
def test_split_and_merge_is_the_plain_version(chunk):
    q, k, v = _inputs(len(LENGTHS), SEQ, 2, 128, seed=1)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    got = _split_and_merge(q, k, v, lengths, 128 ** -0.5, chunk)
    want = da.decode_attention_reference(q, k, v, lengths, 128 ** -0.5)
    assert (got.float() - want.float()).abs().max().item() <= ATOL


def test_chunk_keys_fill_several_waves_in_whole_tiles():
    # the serving cells' decode: 32 heads at D 128 (tiles of 32 keys), 16
    # at D 256 (16 keys); 132 SMs holding 3 blocks each
    assert da.chunk_keys([4200, 5400, 6600, 7800], 32, 132, 3, 32) == 512
    assert da.chunk_keys([1500] * 8, 16, 132, 3, 16) == da.MIN_CHUNK_KEYS
    # whole tiles
    assert da.chunk_keys([8192] * 64, 32, 132, 3, 32) % 32 == 0
    assert da.chunk_keys([8192] * 64, 32, 132, 3, 32) >= (
        32 * 8192 * 64 / (da.WAVES * 132 * 3))
    # short keys: no chunk under MIN_CHUNK_KEYS
    assert da.chunk_keys([1, 1], 2, 132, 3, 16) == da.MIN_CHUNK_KEYS


def test_cpu_tensors_take_the_plain_version_uncounted():
    q, k, v = _inputs(2, 64, 2, 256)
    lengths = torch.tensor([5, 64], dtype=torch.int32)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, lengths, 0.0625, [5, 64])
    assert torch.equal(got, da.decode_attention_reference(q, k, v, lengths,
                                                          0.0625))
    assert da.decode_attention.launches == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "lengths_dtype",
                                 "lengths_shape", "shape", "q_strided",
                                 "k_strided", "host_lengths_long",
                                 "host_lengths_count"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = _inputs(2, 64, 2, 128)
    lengths = torch.tensor([5, 64], dtype=torch.int32)
    hint = [5, 64]
    if bad == "head_dim":
        q, k, v = _inputs(2, 64, 2, 64)
    elif bad == "dtype":
        q = q.float()
    elif bad == "lengths_dtype":
        lengths = lengths.long()
    elif bad == "lengths_shape":
        lengths = lengths[:1]
    elif bad == "shape":
        v = v[:, :32]
    elif bad == "q_strided":
        q = torch.cat([q, q], dim=-1)[..., ::2]
    elif bad == "k_strided":
        k = torch.cat([k, k], dim=-1)[..., ::2]
    elif bad == "host_lengths_long":
        hint = [5, 65]
    elif bad == "host_lengths_count":
        hint = [5]
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, lengths, 0.1, hint)
