"""The decode-attention kernel against its plain version on the card, at
the serving cells' shapes, and through the serving engine's decode step.

The kernel has no CPU mode, so these skip on a host without a card.
This file imports torch and the port only, so it also runs where JAX is
not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_decode_attention_cuda.py`` from the repository root.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from tpu_cluster_torch.kernels import decode_attention as da
from tpu_cluster_torch.kernels import flash_attention as fa
from tpu_cluster_torch.workloads import burnin, serving

# bf16 outputs. The kernel and the plain version share every rounding to
# bf16 (the inputs, the output) and differ in f32 summation order and in
# exp2 of base-2 scores against exp, which may move the output's one
# rounding by an ulp: max-abs within 2^-7 of max|plain| (one ulp at the
# largest magnitude), mean-abs within 1e-3 of mean|plain|.
MAX_REL = 2 ** -7
MEAN_REL = 1e-3

# (slots, seq, heads, head_dim): mpt7b8k-serve-offline's and
# gptj6b-serve-poisson's caches
SHAPES = [(4, 8192, 32, 128), (8, 2048, 16, 256)]
LENGTHS = (1, 64, 65, 4097)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _lengths(slots, seq, turn):
    """Each of 1, 64, 65, 4097 and seq (those within seq), in turn from
    ``turn`` on, over the slots."""
    pool = [n for n in LENGTHS if n <= seq] + [seq]
    return [pool[(turn + i) % len(pool)] for i in range(slots)]


@pytest.mark.cuda
@pytest.mark.parametrize("turn", [0, 1])
@pytest.mark.parametrize("slots,seq,heads,head_dim", SHAPES)
def test_kernel_matches_plain_version(slots, seq, heads, head_dim, turn):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(turn)
    q = torch.randn((slots, heads, head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((slots, seq, heads, head_dim), generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    lens = _lengths(slots, seq, turn)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = da.decode_attention.launches
    out = da.decode_attention(q, k, v, lengths, head_dim ** -0.5, lens)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    ref = da.decode_attention_reference(q, k, v, lengths, head_dim ** -0.5)
    err = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    assert err.max().item() <= MAX_REL * mag.max().item(), err.max().item()
    assert err.mean().item() <= MEAN_REL * mag.mean().item(), \
        err.mean().item()
    # length 1 attends the slot's first key alone: its value row, exactly
    for s, n in enumerate(lens):
        if n == 1:
            assert torch.equal(out[s], v[s, 0])


@pytest.mark.cuda
def test_kernel_reads_strided_caches():
    """K and V as views into one [slots, seq, 2, H, D] buffer: the plain
    version's outputs."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    kv = torch.randn((2, 1024, 2, 4, 128), generator=gen,
                     device=dev).to(torch.bfloat16)
    k, v = kv.unbind(2)
    q = torch.randn((2, 4, 128), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([1000, 257], dtype=torch.int32, device=dev)
    ref = da.decode_attention_reference(q, k, v, lengths, 0.088)
    out = da.decode_attention(q, k, v, lengths, 0.088, [1000, 257])
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= MAX_REL * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [2048, 1000])
def test_decode_step_launches_the_kernel_and_not_k1(seq):
    """The engine's decode at a kernel width, at a seq K1's selector takes
    and at one it does not (under its crossover, not whole tiles): one
    decode-attention launch a call, no K1, and the greedy picks of the
    uncached forward (with the attention K1's selector picks)."""
    dev = _card()
    cfg = serving.ServingConfig(vocab=512, d_model=1024, d_ff=2048,
                                n_heads=8, seq=seq, slots=3)
    eng = serving.InferenceEngine(cfg, device=dev)
    mcfg = eng.model_config()
    assert mcfg.attention == "flash"
    params, decode, _ = eng._ensure_model()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (3, cfg.seq)).astype(np.int32)
    pos = np.array([0, 700, seq - 1], np.int32)
    before = (da.decode_attention.launches, fa.flash_attention.launches)
    for _ in range(3):
        ids = decode(params, tokens, pos)
    assert (da.decode_attention.launches - before[0],
            fa.flash_attention.launches - before[1]) == (3, 0)
    uncached = replace(mcfg, attention=burnin.select_attention(mcfg, "cuda"))
    with torch.inference_mode():
        full = burnin.forward(params, torch.from_numpy(tokens).to(dev),
                              uncached,
                              at=torch.from_numpy(pos).to(dev).long())
    top2 = full.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.1
    picks = full.argmax(-1).cpu().numpy()
    assert (ids[clear.cpu().numpy()] == picks[clear.cpu().numpy()]).all()
