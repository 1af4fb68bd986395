"""The sharded step and the LM head on the card: mesh (1, 1), a one-rank
NCCL group, at a small flash shape computes what ``train_step`` does and
launches K1, K2 and K3 once a step; the LM head's tensor-core route
against the f32 product of its up-cast operands.

They need a card, so they skip on a host without one. This file imports
torch and the port only, so it also runs where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_sharded_cuda.py``
from the repository root.
"""

import pytest
import torch

from tpu_cluster_torch.kernels import flash_attention as fa
from tpu_cluster_torch.workloads import burnin, collectives

# d_head 256 and seq a multiple of 64: the flash kernels' shapes.
CFG = burnin.BurninConfig(vocab=1024, d_model=512, d_ff=2048, n_heads=2,
                          seq=512, batch=2, attention="flash")
STEPS = 3
# Losses of the same computation: only a kernel or GEMM choice that
# differs between two calls could move them (test_torch_train.py's
# LOSS_ATOL, the bound between the two packages, is far looser).
LOSS_ATOL = 2e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mesh_1x1_matches_train_step_on_the_card():
    dev = _card()
    params, batch = burnin.seeded_inputs(CFG, dev)
    p, want = params, []
    for _ in range(STEPS):
        p, loss = burnin.train_step(p, batch, CFG)
        want.append(float(loss))
    kernels = (fa.flash_attention, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    with collectives.process_group(dev):
        mesh = burnin.make_mesh((1, 1), dev)
        step, q, b = burnin.make_sharded_step(mesh, CFG)
        for fn in kernels:
            fn.launches = 0
        got = []
        for _ in range(STEPS):
            q, loss = step(q, b)
            got.append(float(loss))
        launches = [fn.launches for fn in kernels]
    assert launches == [STEPS] * 3
    assert all(abs(a - w) <= LOSS_ATOL for a, w in zip(got, want)), \
        (got, want)
    for name in p:
        torch.testing.assert_close(q[name], p[name], rtol=0, atol=1e-6)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (torch.tensor(x).abs().log2().floor().item() - 7)


# Of the gradients' elements, the share that may round otherwise than the
# f32 route's (chip_smoke.py's HEAD_GRAD_MISMATCH: the split cotangent
# gives ~0.5% on an H100, its high half alone ~42%).
GRAD_MISMATCH = 0.02


@pytest.mark.cuda
def test_lm_head_tensor_cores_against_the_f32_product():
    """Logits within sqrt(D) * u * sum|y w| of the f32 product (both are f32
    sums of the same exact products, in other orders; u = 2^-24), a bound
    that the f32 product rounded to bf16 exceeds. Each gradient within
    one bf16 ulp of its largest magnitude, with at most GRAD_MISMATCH of
    its elements rounded otherwise than the f32 route's, a share that the
    high half of the cotangent alone exceeds."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    n, d, v = 1024, 4096, 2048
    y = torch.randn(n, d, generator=gen, device=dev).bfloat16()
    w = (torch.randn(d, v, generator=gen, device=dev) * d ** -0.5).bfloat16()
    g = torch.randn(n, v, generator=gen, device=dev) * 1e-4
    yl, wl = y.clone().requires_grad_(), w.clone().requires_grad_()
    logits = burnin.lm_head(yl, wl)
    dy, dw = torch.autograd.grad(logits, (yl, wl), g)
    assert logits.dtype == torch.float32
    assert dy.dtype == dw.dtype == torch.bfloat16

    want = y.float() @ w.float()
    bound = d ** 0.5 * 2.0 ** -24 * (y.float().abs() @ w.float().abs())
    assert bool(((logits - want).abs() <= bound).all())
    assert not bool(((want.bfloat16().float() - want).abs() <= bound).all())
    want_dy = (g @ w.float().t()).bfloat16()
    want_dw = (y.float().t() @ g).bfloat16()
    hi = g.bfloat16()
    hi_dy = torch.mm(hi, w.t(), out_dtype=torch.float32).bfloat16()
    hi_dw = torch.mm(y.t(), hi, out_dtype=torch.float32).bfloat16()
    for got, ref, hi_only in ((dy, want_dy, hi_dy), (dw, want_dw, hi_dw)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= _bf16_ulp(ref.float().abs().max().item()), err
        frac = (got != ref).float().mean().item()
        assert frac <= GRAD_MISMATCH, frac
        assert (hi_only != ref).float().mean().item() > GRAD_MISMATCH
