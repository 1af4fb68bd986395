"""The flash-attention kernels (K1 forward with its lse, K2 dK/dV, K3 dQ)
against their plain versions on the card.

The kernels have no CPU mode, so these skip on a host without a card.
This file imports torch and the port only, so it also runs where JAX is
not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention_cuda.py`` from the repository root.
"""

import pytest
import torch

from tpu_cluster_torch.kernels import flash_attention as fa

# bf16 outputs: the kernel's running max rounds P to bf16 differently from
# the plain version's single max, so a value may land one bf16 ulp away
# (1.6e-2 at magnitudes in [2, 4)); the mean error stays far below it.
MAX_ABS = 1.6e-2
MEAN_ABS = 2e-4
# lse (f32): the kernel's running max and exp2 against one max and exp;
# f32 rounding of values below 10.
LSE_ATOL = 1e-4
# dq, dk, dv (bf16), relative to the plain version's magnitude (gradients
# sum S terms): f32 summation order moves a bf16 rounding of P, dS or an
# output by about one ulp, at most 2^-7 of the largest magnitude; the mean
# error stays far below it.
BWD_MAX_REL = 1e-2
BWD_MEAN_REL = 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the kernel has no CPU mode")
    return torch.device("cuda")


# The last two have S = 64 mod 128: the kernel's last 128-row query tile
# is half past S (rows loaded as zeros, never stored).
SHAPES = [(2, 512, 4, 128), (2, 512, 4, 256), (1, 64, 1, 128),
          (1, 64, 1, 256), (1, 192, 3, 256), (2, 576, 4, 128),
          (2, 1088, 3, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads,head_dim", SHAPES)
def test_kernel_matches_plain_version(batch, seq, heads, head_dim):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((batch, seq, heads, head_dim), generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, head_dim ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_reference(q, k, v, head_dim ** -0.5)
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= MAX_ABS and err.mean().item() <= MEAN_ABS, \
        (err.max().item(), err.mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize("seq,head_dim", [(256, 128), (576, 256)])
def test_kernel_takes_strided_projection_views(seq, head_dim):
    """q, k, v as views into one fused [B, S, 3, H, D] buffer: the kernel
    reads them through their strides (its tensor maps), with no copies."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    fused = torch.randn((2, seq, 3, 4, head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
    q, k, v = fused.unbind(2)
    assert not q.is_contiguous()
    out, lse = fa.flash_attention_with_lse(q, k, v, head_dim ** -0.5)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, head_dim ** -0.5,
                                                return_lse=True)
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= MAX_ABS and err.mean().item() <= MEAN_ABS
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL


@pytest.mark.cuda
def test_kernel_takes_head_major_views():
    """q, k, v as [B, S, H, D] views of [B, H, S, D] tensors: the head
    stride exceeds the row stride."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((2, 3, 576, 256), generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    assert q.stride(2) > q.stride(1)
    out = fa.flash_attention(q, k, v, 256 ** -0.5)
    ref = fa.flash_attention_reference(q, k, v, 256 ** -0.5)
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= MAX_ABS and err.mean().item() <= MEAN_ABS


def _inputs(dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(4)]


def _rel_err(got, want):
    err = (got.float() - want.float()).abs()
    return (err.max().item() / want.float().abs().max().item(),
            err.mean().item() / want.float().abs().mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads,head_dim", SHAPES)
def test_lse_matches_plain_version(batch, seq, heads, head_dim):
    dev = _card()
    q, k, v, _ = _inputs(dev, (batch, seq, heads, head_dim), 2)
    out, lse = fa.flash_attention_with_lse(q, k, v, head_dim ** -0.5)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, head_dim ** -0.5,
                                                    return_lse=True)
    assert lse.shape == (batch, heads, seq) and lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    assert (out.float() - ref_out.float()).abs().max().item() <= MAX_ABS


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads,head_dim", SHAPES)
def test_backward_kernels_match_plain_versions(batch, seq, heads, head_dim):
    dev = _card()
    scale = head_dim ** -0.5
    q, k, v, do = _inputs(dev, (batch, seq, heads, head_dim), 3)
    out, lse = fa.flash_attention_reference(q, k, v, scale, return_lse=True)
    di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    before = (fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, scale)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == (before[0] + 1,
                                                    before[1] + 1)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, di, scale)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, di,
                                                  scale)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        max_rel, mean_rel = _rel_err(got, want)
        assert max_rel <= BWD_MAX_REL and mean_rel <= BWD_MEAN_REL, \
            (name, max_rel, mean_rel)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,heads,head_dim", [(256, 4, 128),
                                                (576, 3, 256)])
def test_backward_kernels_take_strided_views(seq, heads, head_dim):
    """q, k, v, dO as views into fused [B, S, 4, H, D] buffers, read
    through their tensor maps; at S = 576 K3's last 128-row query tile is
    half past S."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    fused = torch.randn((2, seq, 4, heads, head_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
    q, k, v, do = fused.unbind(2)
    assert not do.is_contiguous()
    scale = head_dim ** -0.5
    out, lse = fa.flash_attention_reference(q, k, v, scale, return_lse=True)
    di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, scale)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse, di, scale)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, di,
                                                  scale)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        max_rel, mean_rel = _rel_err(got, want)
        assert max_rel <= BWD_MAX_REL and mean_rel <= BWD_MEAN_REL, \
            (name, max_rel, mean_rel)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads,head_dim",
                         [(2, 576, 4, 128), (2, 1088, 3, 256)])
def test_backward_kernels_are_deterministic(batch, seq, heads, head_dim):
    """Each output tile has one writer and no atomics: two calls on the
    same inputs give bitwise-equal dQ, dK and dV."""
    dev = _card()
    scale = head_dim ** -0.5
    q, k, v, do = _inputs(dev, (batch, seq, heads, head_dim), 9)
    _, lse = fa.flash_attention_with_lse(q, k, v, scale)
    di = torch.randn((batch, heads, seq), generator=torch.Generator(
        device=dev).manual_seed(10), device=dev)
    first = (*fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, scale),
             fa.flash_attention_bwd_dq(q, k, v, do, lse, di, scale))
    second = (*fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, scale),
              fa.flash_attention_bwd_dq(q, k, v, do, lse, di, scale))
    torch.cuda.synchronize()
    for name, a, b in zip(("dk", "dv", "dq"), first, second):
        assert torch.equal(a, b), name
        assert bool(torch.isfinite(a).all()), name


@pytest.mark.cuda
def test_backward_kernels_raise_on_unsupported_inputs():
    dev = _card()
    q, k, v, do = _inputs(dev, (1, 128, 2, 128), 5)
    lse = torch.zeros((1, 2, 128), device=dev)
    before = (fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    for fn in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match="do must be bfloat16"):
            fn(q, k, v, do.float(), lse, lse, 0.1)
        with pytest.raises(ValueError, match="di must be"):
            fn(q, k, v, do, lse, lse[..., :64], 0.1)
        with pytest.raises(ValueError, match="lse is on cpu"):
            fn(q, k, v, do, lse.cpu(), lse, 0.1)
    assert (fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == before


@pytest.mark.cuda
def test_autograd_backward_launches_the_kernels(monkeypatch):
    """On CUDA tensors the differentiable path runs K1 (with lse), K2 and
    K3, once each, and never a plain version."""
    dev = _card()

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("flash_attention_reference",
                 "flash_attention_bwd_dkv_reference",
                 "flash_attention_bwd_dq_reference"):
        monkeypatch.setattr(fa, name, refuse)
    q, k, v, do = _inputs(dev, (1, 256, 2, 256), 6)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = (fa.flash_attention.launches, fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    out = fa.flash_attention(q, k, v, 256 ** -0.5)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == tuple(
                n + 1 for n in before)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["standard", "bench"])
def test_crossover_check_point_flash_agrees_with_xla(width):
    """The crossover sweep's correctness point at full width (d_head 256
    and 128): flash logits, loss and gradients against the xla path's,
    within the tolerances chip_smoke.py states."""
    from tpu_cluster_torch.kernels import crossover

    result = crossover.check_point(width, _card())
    assert result["ok"], result
