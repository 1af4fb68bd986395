"""The sparse decoder's expert products and whole step on the card: the
grouped products (``torch._grouped_mm``) against a loop over the
experts, experts with no rows among them, and one step of the small
model against the f32 reference.

Imports torch, the port and the benchmark's reference only, so it runs
where JAX is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_sparse_cuda.py`` from the repository root.
"""

import dataclasses

import pytest
import torch

from portbench.reference import sparse as ref
from tpu_cluster_torch.workloads import burnin, sparse


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _loop(xs, w1, w3, w2, counts):
    """The expert products one expert at a time."""
    out, start = [], 0
    for e, n in enumerate(counts):
        x = xs[start:start + n]
        out.append((torch.nn.functional.silu(x @ w1[e]) * (x @ w3[e]))
                   @ w2[e])
        start += n
    return torch.cat(out)


@pytest.mark.cuda
def test_grouped_products_match_the_loop():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    e, d, f = 8, 256, 128
    counts = [40, 0, 8, 200, 16, 0, 64, 56]
    m = sum(counts)
    xs = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
    dys = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
    ws = [(torch.randn(shape, generator=gen, device=dev) * 0.1)
          .to(torch.bfloat16) for shape in ((e, d, f), (e, d, f), (e, f, d))]
    offs = torch.tensor(counts, device=dev).cumsum(0).to(torch.int32)
    outs = []
    for run in (lambda x, *w: sparse._Experts.apply(x, *w, offs, None),
                lambda x, *w: _loop(x, *w, counts)):
        leaves = [t.detach().requires_grad_() for t in (xs, *ws)]
        ys = run(*leaves)
        outs.append((ys, *torch.autograd.grad(ys, leaves, dys)))
    for a, b in zip(*outs):
        # bf16 results of two summation orders: about one ulp
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err < 1e-2
    for g in outs[0][2:]:
        assert torch.all(g[1] == 0) and torch.all(g[5] == 0)
@pytest.mark.cuda
def test_a_step_on_the_card_follows_the_reference():
    dev = _card()
    cfg = dataclasses.replace(sparse.SparseConfig(), top_k=8)
    params = sparse.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    targets = torch.roll(tokens, -1, 1)
    loss, grads = burnin.loss_and_grads(params, (tokens, targets), cfg)
    model = dict(d_model=cfg.d_model, n_heads=cfg.n_heads,
                 n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                 n_experts=cfg.n_experts, top_k=cfg.top_k,
                 d_expert=cfg.d_expert, vocab=cfg.vocab, layers=4,
                 layer_types=list(cfg.layer_types), window=cfg.window,
                 rope_theta=cfg.rope_theta,
                 yarn=dataclasses.asdict(cfg.yarn), norm_eps=cfg.norm_eps)
    torch.backends.cuda.matmul.allow_tf32 = False
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    want_loss = ref.loss(leaves, tokens, targets, model)
    want = torch.autograd.grad(want_loss, list(leaves.values()))
    assert abs(float(loss) - float(want_loss)) / float(want_loss) < 1e-3
    # as tests/test_torch_sparse.py on the CPU: every expert routed, each
    # gradient within a few bf16 roundings of its norm
    for (name, g), w in zip(grads.items(), want):
        rel = float((g - w).norm() / w.norm())
        assert rel < 0.06, (name, rel)
