"""The port's flash attention, forward and backward, against the
reference's attention and upstream's TPU kernels.

On a host without a card the wrappers take the plain versions, so these
pin the plain versions' arithmetic against upstream JAX's
``mha_reference_no_custom_vjp`` (f32), against
``burnin._chunked_attention`` (bf16, the arithmetic K1 repeats), and
against upstream's own kernels K1 (with residuals), K2 and K3 run in
Pallas TPU interpret mode on the CPU (under ``jax.jit``), plus the
wrappers' device routing, shape checks and the autograd Function. The
kernels themselves are held against the plain versions on the card by
tests/test_torch_flash_attention_cuda.py and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as upstream
from jax.experimental.pallas.ops.tpu.flash_attention import (
    mha_reference_no_custom_vjp)

from tpu_cluster.workloads import burnin as jax_burnin
from tpu_cluster_torch.kernels import flash_attention as fa

HEAD_DIMS = fa.SUPPORTED_HEAD_DIMS


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_plain_matches_upstream_mha_reference_f32(head_dim):
    """f32 end to end: the two differ only in summation order and in
    normalising before (upstream) or after (port) P V, so 1e-5 covers a
    few f32 roundings at outputs of magnitude < 4."""
    q, k, v = _qkv(0, (2, 128, 2, head_dim))
    scale = head_dim ** -0.5
    ref = mha_reference_no_custom_vjp(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
        causal=True, sm_scale=scale)
    ref = np.asarray(ref).transpose(0, 2, 1, 3)
    out = fa.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_plain_matches_chunked_attention_bf16(head_dim):
    """bf16 in the [B, S, H, D] layout against the reference's chunked
    recurrence (f32 statistics, P rounded to bf16 before P V). The running
    max rounds P differently from one global max, so a value may land one
    bf16 ulp away: 1.6e-2 is one ulp at magnitudes in [2, 4); the mean
    must stay far below it."""
    q, k, v = _qkv(1, (2, 256, 2, head_dim))
    ref = jax_burnin._chunked_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), head_dim, 64)
    ref = np.asarray(ref.astype(jnp.float32))
    out = fa.flash_attention_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        head_dim ** -0.5).float().numpy()
    err = np.abs(out - ref)
    assert err.max() <= 1.6e-2, err.max()
    assert err.mean() <= 2e-4, err.mean()


def test_wrapper_takes_plain_version_on_cpu_tensors():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(2, (1, 128, 2, 128)))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, 128 ** -0.5)
    assert fa.flash_attention.launches == before
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert out.is_contiguous()
    torch.testing.assert_close(
        out, fa.flash_attention_reference(q, k, v, 128 ** -0.5),
        rtol=0, atol=0)


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 128, 2, 64), torch.bfloat16, "head_dim 64"),
    ((1, 128, 2, 192), torch.bfloat16, "head_dim 192"),
    ((1, 100, 2, 128), torch.bfloat16, "seq 100"),
    ((1, 0, 2, 128), torch.bfloat16, "seq 0"),
    ((1, 128, 2, 128), torch.float32, "bfloat16"),
])
def test_wrapper_rejects_unsupported_inputs(shape, dtype, match):
    q = torch.zeros(shape, dtype=dtype)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, q.clone(), q.clone(), 0.1)
    assert fa.flash_attention.launches == before


def test_wrapper_rejects_mismatched_or_strided_inputs():
    q = torch.zeros((1, 128, 2, 128), dtype=torch.bfloat16)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="share one"):
        fa.flash_attention(q, q[:, :64], q, 0.1)
    d_strided = torch.zeros((1, 128, 2, 256), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous in D"):
        fa.flash_attention(d_strided, d_strided, d_strided, 0.1)
    assert fa.flash_attention.launches == before



# --- The backward: plain versions against upstream's kernels -------------

# upstream's default flash blocks (BlockSizes.get_default)
UP_BLOCK = 128


def _bf16(*arrays):
    return [jnp.asarray(x, jnp.bfloat16) for x in arrays]


def _torch_bf16(*arrays):
    return [torch.from_numpy(x).to(torch.bfloat16) for x in arrays]


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))  # a writable copy


def _upstream_kernels(q, k, v, do, scale, block_q=UP_BLOCK,
                      block_k=UP_BLOCK):
    """Upstream's K1 with residuals (o, l, m), di, K2 (dk, dv) and K3 (dq)
    on bf16 ``[B, S, H, D]`` inputs, in TPU interpret mode, with query
    blocks of ``block_q`` rows and key blocks of ``block_k``. Outputs in
    upstream's [B, H, S, ...] layout."""
    @jax.jit
    def kernels(q, k, v, do):
        qt, kt, vt, dot = (x.transpose(0, 2, 1, 3) for x in (q, k, v, do))
        o, l, m = upstream._flash_attention_impl(
            qt, kt, vt, None, None, True, True, scale, 1, block_q, block_k,
            block_k, False)
        di = jnp.sum(o.astype(jnp.float32) * dot.astype(jnp.float32), -1)
        dk, dv = upstream._flash_attention_bwd_dkv(
            qt, kt, vt, None, None, l, m, dot, di, block_q_major=block_q,
            block_q=block_q, block_k_major=block_k, block_k=block_k,
            sm_scale=scale, causal=True)
        dq, _ = upstream._flash_attention_bwd_dq(
            qt, kt, vt, None, None, l, m, dot, di, block_q_major=block_q,
            block_k_major=block_k, block_k=block_k, sm_scale=scale,
            causal=True, mask_value=upstream.DEFAULT_MASK_VALUE, debug=False)
        return o, l, m, di, dq, dk, dv

    with pltpu.force_tpu_interpret_mode():
        return [_np(x) for x in kernels(*_bf16(q, k, v, do))]


def _assert_rel_close(got, want, max_rel, mean_rel, name):
    """max|got - want| <= max_rel * max|want| and the same for the means."""
    got = got.float().numpy()
    err = np.abs(got - want)
    assert err.max() <= max_rel * np.abs(want).max(), \
        (name, err.max(), np.abs(want).max())
    assert err.mean() <= mean_rel * np.abs(want).mean(), \
        (name, err.mean(), np.abs(want).mean())


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_plain_versions_match_upstream_kernels(head_dim):
    """K1's lse, K2's and K3's plain versions against upstream's kernels
    on the same bf16 inputs, the backward fed upstream's own residuals
    (lse = m + log l) and di, so each plain version is held alone.

    - lse (f32): the two differ by f32 rounding of exp and of the sum
      order (|lse| < 10 here): 1e-5.
    - o (bf16): the running max may round P one bf16 ulp away from the
      global max: 1.6e-2, one ulp at magnitudes in [2, 4).
    - dq, dk, dv (bf16): exp(s - lse) against exp(s - m) / l and the
      summation order differ by f32 rounding, which may move a bf16
      rounding of P, dS or the output by one ulp: max-abs within 2^-7 of
      max|ref| (one ulp at the largest magnitude), mean-abs within 1e-4
      of mean|ref|."""
    shape = (1, 256, 2, head_dim)
    scale = head_dim ** -0.5
    q, k, v, do = _qkv(4, shape) + _qkv(5, shape)[:1]
    o, l, m, di, dq, dk, dv = _upstream_kernels(q, k, v, do, scale)
    tq, tk, tv, tdo = _torch_bf16(q, k, v, do)

    out, lse = fa.flash_attention_reference(tq, tk, tv, scale,
                                            return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 256)
    np.testing.assert_allclose(lse.numpy(), m + np.log(l), rtol=0, atol=1e-5)
    assert np.abs(out.float().numpy() - o.transpose(0, 2, 1, 3)).max() \
        <= 1.6e-2

    up_lse = torch.from_numpy(m + np.log(l))
    up_di = torch.from_numpy(di)
    got_dk, got_dv = fa.flash_attention_bwd_dkv_reference(
        tq, tk, tv, tdo, up_lse, up_di, scale)
    got_dq = fa.flash_attention_bwd_dq_reference(tq, tk, tv, tdo, up_lse,
                                                 up_di, scale)
    for name, got, want in (("dq", got_dq, dq), ("dk", got_dk, dk),
                            ("dv", got_dv, dv)):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        _assert_rel_close(got, want.transpose(0, 2, 1, 3), 2 ** -7, 1e-4,
                          name)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_plain_backward_matches_upstream_kernels_at_ragged_seq(head_dim):
    """The plain K2 and K3 against upstream's dkv and dq kernels at S = 192,
    which K3's 128-row query tiles split unevenly, with B, H > 1 and
    upstream query blocks of 64 rows, fed upstream's own residuals (lse =
    m + log l) and di.

    Upstream's backward kernels tile m, l and di across 128-wide key
    blocks, so they take no S that is not a multiple of 128: they run on
    the inputs zero-padded to S = 256 (key blocks of 128). That changes
    nothing in the first 192 rows: a causal row sees no later key, and a
    padded query (q = dO = 0, so dp = di = 0 and dS = 0) adds exactly zero
    to dK and dV. Tolerances and reasons as in
    test_plain_versions_match_upstream_kernels: exp(s - lse) against
    exp(s - m) / l and the summation order differ by f32 rounding, which
    may move a bf16 rounding of P, dS or the output by one ulp: max-abs
    within 2^-7 of max|ref|, mean-abs within 1e-4 of mean|ref|."""
    shape = (2, 192, 3, head_dim)
    scale = head_dim ** -0.5
    q, k, v, do = _qkv(12, shape) + _qkv(13, shape)[:1]
    pad = [np.concatenate([x, np.zeros((2, 64, 3, head_dim), x.dtype)], 1)
           for x in (q, k, v, do)]
    _, l, m, di, dq, dk, dv = _upstream_kernels(*pad, scale, block_q=64,
                                                block_k=128)
    rows = slice(0, 192)
    tq, tk, tv, tdo = _torch_bf16(q, k, v, do)
    up_lse = torch.from_numpy(m[:, :, rows] + np.log(l[:, :, rows]))
    up_di = torch.from_numpy(np.ascontiguousarray(di[:, :, rows]))
    assert up_lse.shape == (2, 3, 192) and up_di.shape == (2, 3, 192)
    got_dk, got_dv = fa.flash_attention_bwd_dkv_reference(
        tq, tk, tv, tdo, up_lse, up_di, scale)
    got_dq = fa.flash_attention_bwd_dq_reference(tq, tk, tv, tdo, up_lse,
                                                 up_di, scale)
    for name, got, want in (("dq", got_dq, dq), ("dk", got_dk, dk),
                            ("dv", got_dv, dv)):
        assert got.dtype == torch.bfloat16 and got.shape == shape
        _assert_rel_close(got, want[:, :, rows].transpose(0, 2, 1, 3),
                          2 ** -7, 1e-4, name)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_plain_forward_matches_upstream_kernel_at_ragged_seq(head_dim):
    """The plain K1 and its lse against upstream's K1 (with residuals) at
    S = 192, which the kernel's 128-row query tiles split unevenly, with
    B, H > 1; upstream runs 64-row query blocks over the whole KV length.

    - o (bf16): XLA's exp and torch's differ by a few f32 ulps, which
      moves bf16 roundings of P and of o, so about half the values sit one
      bf16 ulp apart (measured: mean-abs 2.0e-3 of mean|o|): max-abs
      1.6e-2, one ulp at magnitudes in [2, 4); mean-abs within one ulp
      relative, 2^-8, of mean|o|.
    - lse (f32) against m + log l: f32 rounding of exp and of the sum
      order (|lse| < 10 here): 1e-5."""
    shape = (2, 192, 3, head_dim)
    scale = head_dim ** -0.5
    q, k, v = _qkv(11, shape)

    @jax.jit
    def forward(q, k, v):
        qt, kt, vt = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
        return upstream._flash_attention_impl(
            qt, kt, vt, None, None, True, True, scale, 1, 64, 192, 192,
            False)

    with pltpu.force_tpu_interpret_mode():
        o, l, m = (_np(x) for x in forward(*_bf16(q, k, v)))
    out, lse = fa.flash_attention_reference(*_torch_bf16(q, k, v), scale,
                                            return_lse=True)
    assert out.shape == shape and lse.shape == (2, 3, 192)
    np.testing.assert_allclose(lse.numpy(), m + np.log(l), rtol=0, atol=1e-5)
    want = o.transpose(0, 2, 1, 3)
    err = np.abs(out.float().numpy() - want)
    assert err.max() <= 1.6e-2, err.max()
    assert err.mean() <= 2 ** -8 * np.abs(want).mean(), err.mean()


def test_autograd_function_matches_upstream_vjp():
    """The port's differentiable ``flash_attention`` (plain K1 with lse,
    then plain K2 and K3 on the CPU) against ``jax.vjp`` of upstream's
    ``flash_attention`` in interpret mode, on the same bf16 q, k, v, dO.
    The port's o may sit one bf16 ulp from upstream's (running max), which
    moves di = rowsum(o dO) and through it every dS: max-abs within 1e-2
    of max|ref|, mean-abs within 1e-3 of mean|ref|."""
    shape = (1, 256, 2, 128)
    scale = 128 ** -0.5
    q, k, v, do = _qkv(6, shape) + _qkv(7, shape)[:1]

    @jax.jit
    def vjp(q, k, v, do):
        t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
        _, pull = jax.vjp(lambda a, b, c: upstream.flash_attention(
            a, b, c, causal=True, sm_scale=scale), t(q), t(k), t(v))
        return [t(g) for g in pull(t(do))]

    with pltpu.force_tpu_interpret_mode():
        want = [_np(g) for g in vjp(*_bf16(q, k, v, do))]
    tq, tk, tv, tdo = (x.requires_grad_() for x in _torch_bf16(q, k, v, do))
    out = fa.flash_attention(tq, tk, tv, scale)
    got = torch.autograd.grad(out, (tq, tk, tv), tdo.detach())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == shape
        _assert_rel_close(g, w, 1e-2, 1e-3, name)


def test_backward_wrappers_take_plain_versions_on_cpu_tensors():
    shape = (1, 128, 2, 128)
    scale = 128 ** -0.5
    tq, tk, tv, tdo = _torch_bf16(*(_qkv(8, shape) + _qkv(9, shape)[:1]))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, scale)
    di = (out.float() * tdo.float()).sum(-1).transpose(1, 2).contiguous()
    before = (fa.flash_attention.launches, fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, di, scale)
    dq = fa.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, di, scale)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == before
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        tq, tk, tv, tdo, lse, di, scale)
    for got, want in ((dk, want_dk), (dv, want_dv),
                      (dq, fa.flash_attention_bwd_dq_reference(
                          tq, tk, tv, tdo, lse, di, scale))):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    ref_out, ref_lse = fa.flash_attention_reference(tq, tk, tv, scale, True)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)


def test_flash_attention_records_autograd_only_when_asked():
    tq, tk, tv = _torch_bf16(*_qkv(10, (1, 64, 1, 128)))
    plain = fa.flash_attention(tq, tk, tv, 0.1)
    assert plain.grad_fn is None
    tq.requires_grad_()
    with torch.no_grad():
        assert fa.flash_attention(tq, tk, tv, 0.1).grad_fn is None
    out = fa.flash_attention(tq, tk, tv, 0.1)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)


def _bwd_inputs(shape=(1, 128, 2, 128)):
    tq, tk, tv, tdo = (torch.zeros(shape, dtype=torch.bfloat16)
                       for _ in range(4))
    stats = torch.zeros((shape[0], shape[2], shape[1]))
    return tq, tk, tv, tdo, stats, stats.clone()


@pytest.mark.parametrize("bad,match", [
    ("do_shape", "share one"),
    ("do_dtype", "do must be bfloat16"),
    ("do_strided", "do must be contiguous in D"),
    ("lse_shape", "lse must be"),
    ("di_dtype", "di must be contiguous float32"),
    ("lse_layout", "lse must be contiguous float32"),
])
def test_backward_wrappers_reject_unsupported_inputs(bad, match):
    tq, tk, tv, tdo, lse, di = _bwd_inputs()
    if bad == "do_shape":
        tdo = tdo[:, :64]
    elif bad == "do_dtype":
        tdo = tdo.float()
    elif bad == "do_strided":
        tdo = torch.zeros((1, 128, 2, 256), dtype=torch.bfloat16)[..., ::2]
    elif bad == "lse_shape":
        lse = lse[..., :64]
    elif bad == "di_dtype":
        di = di.double()
    elif bad == "lse_layout":
        lse = lse.transpose(1, 2).contiguous().transpose(1, 2)
    before = (fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    for fn in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match=match):
            fn(tq, tk, tv, tdo, lse, di, 0.1)
    assert (fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == before
