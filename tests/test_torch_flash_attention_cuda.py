"""The flash-attention kernel against its plain version on the card.

The kernel has no CPU mode, so these skip on a host without a card. This
file imports torch and the port only, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda
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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads,head_dim", [
    (2, 512, 4, 128), (2, 512, 4, 256), (1, 64, 1, 128), (1, 64, 1, 256),
    (1, 192, 3, 256)])
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
def test_kernel_takes_strided_projection_views():
    """q, k, v as views into one fused [B, S, 3, H, D] buffer: the kernel
    reads them through their strides, with no copies."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    fused = torch.randn((2, 256, 3, 4, 128), generator=gen,
                        device=dev).to(torch.bfloat16)
    q, k, v = fused.unbind(2)
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, 128 ** -0.5)
    ref = fa.flash_attention_reference(q, k, v, 128 ** -0.5)
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= MAX_ABS and err.mean().item() <= MEAN_ABS
