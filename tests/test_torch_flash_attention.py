"""The port's flash-attention forward against the reference's attention.

On a host without a card the wrapper takes the plain version, so these
pin the plain version's arithmetic against upstream JAX's
``mha_reference_no_custom_vjp`` (f32) and against
``burnin._chunked_attention`` (bf16, the arithmetic the kernel repeats),
plus the wrapper's device routing and shape checks. The kernel itself is
held against the plain version on the card by
tests/test_torch_flash_attention_cuda.py and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
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

