"""The port's sparse decoder (``workloads/sparse.py``) and the window of
its attention kernels, on the CPU at a small size, against the plain
reference of ``portbench/reference/sparse.py`` (f32) and against
brute-force masks.

Small size: d_model 256, 4 query and 2 key heads of 128, 8 experts of
width 64, one period of 4 layers (3 sliding, 1 full), window 16, seq 64,
batch 2, seeded weights.

The program computes in bf16 and the reference in f32, so near-tied
routes can go either way: with top-2 of 8 experts a few of 128 tokens a
layer take another expert in one of the two, and the outputs of those
tokens then differ outright. The whole-model comparisons therefore run
with every expert routed (``top_k == n_experts``: the router's softmax
weights still carry its gradient), and the choice of the top k is held
on its own, on one input for both.
"""

import dataclasses
import math

import pytest
import torch

from portbench import harness
from portbench.reference import sparse as ref
from tpu_cluster_torch import telemetry
from tpu_cluster_torch.kernels import flash_attention as fa
from tpu_cluster_torch.workloads import burnin, sparse

CPU = torch.device("cpu")
CFG = sparse.SparseConfig()
BATCH, SEQ = 2, 64
ALL_ROUTED = dataclasses.replace(CFG, top_k=CFG.n_experts)
YARN = dict(factor=16.0, original_max_position_embeddings=8192,
            beta_fast=32.0, beta_slow=1.0,
            attention_factor=1.2772588722239782)

# bf16 compute against f32 over four layers: a few bf16 roundings of
# logits of ~1 (the burn-in block's own bounds), the loss's mean far
# inside, and each gradient within a few bf16 roundings of its norm (the
# query and key projections' gradients, through the scores, move most:
# 3.3% at worst on three seeds, measured).
LOGITS_MAX, LOGITS_MEAN = 0.15, 0.02
LOSS_REL = 1e-3
GRAD_REL = 0.06


def _model(cfg):
    return dict(d_model=cfg.d_model, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
                n_experts=cfg.n_experts, top_k=cfg.top_k,
                d_expert=cfg.d_expert, vocab=cfg.vocab,
                layers=len(cfg.layer_types),
                layer_types=list(cfg.layer_types), window=cfg.window,
                rope_theta=cfg.rope_theta, yarn=dict(YARN),
                norm_eps=cfg.norm_eps)


def _inputs(cfg, seed):
    params = sparse.init_params(cfg, torch.Generator().manual_seed(seed),
                                CPU)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(seed + 1))
    return params, tokens, torch.roll(tokens, -1, 1)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_and_loss_follow_the_reference(seed):
    params, tokens, targets = _inputs(ALL_ROUTED, seed)
    model = _model(ALL_ROUTED)
    with torch.no_grad():
        mine = sparse.forward(params, tokens, ALL_ROUTED)
        want = ref.hidden(params, tokens, model) @ params["out"]
        loss = burnin.loss_fn(params, (tokens, targets), ALL_ROUTED)
        want_loss = ref.loss(params, tokens, targets, model)
    assert mine.dtype == torch.float32 and mine.shape == want.shape
    err = (mine - want).abs()
    assert err.max() < LOGITS_MAX and err.mean() < LOGITS_MEAN
    assert abs(float(loss) - float(want_loss)) / float(want_loss) < LOSS_REL


@pytest.mark.parametrize("seed", [0, 1])
def test_every_gradient_follows_the_reference(seed):
    params, tokens, targets = _inputs(ALL_ROUTED, seed)
    loss, grads = burnin.loss_and_grads(params, (tokens, targets),
                                        ALL_ROUTED)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    want = torch.autograd.grad(
        ref.loss(leaves, tokens, targets, _model(ALL_ROUTED)),
        list(leaves.values()))
    assert list(grads) == list(params)
    for (name, g), w in zip(grads.items(), want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) < GRAD_REL, (name, _rel(g, w))


def test_train_step_is_the_sgd_step_of_the_reference():
    params, tokens, targets = _inputs(ALL_ROUTED, 3)
    tel = telemetry.Telemetry()
    new, loss = burnin.train_step(params, (tokens, targets), ALL_ROUTED,
                                  telemetry=tel)
    losses, first, change = ref.sgd(params, [(tokens, targets)],
                                    _model(ALL_ROUTED), ALL_ROUTED.lr)
    assert abs(float(loss) - losses[0]) / losses[0] < LOSS_REL
    for name, p in new.items():
        moved = float((p - params[name]).norm())
        assert abs(moved - change[name]) <= GRAD_REL * change[name], name
    names = [s.name for s in tel.tracer.walk()]
    for span in telemetry.MOE_SPANS:
        # forward and backward, once a layer each
        assert names.count(span) == 2 * len(ALL_ROUTED.layer_types), span


def test_expert_layer_backward_is_autograds():
    """The four hand-written backwards (route, dispatch, experts,
    combine), in f32, against autograd of the reference's expert
    layer."""
    gen = torch.Generator().manual_seed(5)
    d, e, k, f, n = 32, 8, 3, 16, 64
    y = torch.randn(n, d, generator=gen).requires_grad_()
    ws = [torch.randn(s, generator=gen).mul_(0.3).requires_grad_()
          for s in ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    g = torch.randn(n, d, generator=gen)
    want_out, _ = ref.experts(y, *ws, k, "f32")
    want = torch.autograd.grad((want_out * g).sum(), [y, *ws])
    weights, chosen = sparse._Route.apply(y, ws[0], k, None)
    flat = chosen.reshape(-1)
    order = torch.argsort(flat, stable=True)
    inverse = torch.argsort(order)
    offs = torch.bincount(flat, minlength=e).cumsum(0).to(torch.int32)
    xs = sparse._Dispatch.apply(y, order // k, inverse, k, None)
    ys = sparse._Experts.apply(xs, *ws[1:], offs, None)
    out = sparse._Combine.apply(ys, weights, inverse, order, None)
    got = torch.autograd.grad((out * g).sum(), [y, *ws])
    assert torch.allclose(out, want_out, atol=1e-5)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-4)


def test_top_k_sets_equal_the_references_and_nothing_is_dropped():
    params, tokens, _ = _inputs(CFG, 4)
    gen = torch.Generator().manual_seed(6)
    y = torch.randn(256, CFG.d_model, generator=gen).to(torch.bfloat16)
    router = params["layers.0.router"]
    _, mine = sparse._Route.apply(y, router, CFG.top_k, None)
    _, want = ref.experts(y.float(), router, params["layers.0.w1"],
                          params["layers.0.w3"], params["layers.0.w2"],
                          CFG.top_k, "f32")
    assert torch.equal(mine.sort(-1).values, want.sort(-1).values)
    counters = sparse.RouteCounters(len(CFG.layer_types), CFG.n_experts, CPU)
    with torch.no_grad():
        sparse.forward(params, tokens, CFG, counters=counters)
    got = counters.read()
    assert got["dropped_tokens"] == 0
    rows = BATCH * SEQ
    assert counters.tokens.sum(1).tolist() == [rows * CFG.top_k] * 4
    assert all(x >= 1.0 for x in got["expert_load_max_over_mean"])


def _capacity(flat, n_experts):
    """Each expert's rows cut to the mean, as a capacity factor of 1."""
    counts, _ = GROUP_OFFSETS(flat, n_experts)
    kept = counts.clamp(max=flat.numel() // n_experts)
    return counts, kept.cumsum(0).to(torch.int32)


def _shifted(flat, n_experts):
    """Each expert's group bounded by its neighbour's count."""
    counts, _ = GROUP_OFFSETS(flat, n_experts)
    return counts, counts.roll(1).cumsum(0).to(torch.int32)


GROUP_OFFSETS = sparse.group_offsets


@pytest.mark.parametrize("offsets", [_capacity, _shifted])
def test_pairs_outside_their_experts_group_are_counted(monkeypatch, offsets):
    """A dispatch whose groups leave pairs out (a capacity) or give them
    to another expert (a wrong offset) reads as dropped pairs."""
    params, tokens, _ = _inputs(CFG, 4)
    monkeypatch.setattr(sparse, "group_offsets", offsets)
    counters = sparse.RouteCounters(len(CFG.layer_types), CFG.n_experts, CPU)
    with torch.no_grad():
        sparse.forward(params, tokens, CFG, counters=counters)
    assert counters.read()["dropped_tokens"] > 0


def test_the_trainer_dispatches_on_the_config():
    """``burnin.loss_fn`` runs the sparse model on a ``SparseConfig``, and
    refuses what neither model takes: an axis for the sparse model,
    route counters for the burn-in block."""
    params, tokens, targets = _inputs(CFG, 2)
    with torch.no_grad():
        assert torch.equal(burnin.loss_fn(params, (tokens, targets), CFG),
                           sparse.loss_fn(params, (tokens, targets), CFG))
        with pytest.raises(ValueError, match="axis"):
            burnin.loss_fn(params, (tokens, targets), CFG, axis=object())
    cfg = burnin.BurninConfig(vocab=64, d_model=256, d_ff=256, n_heads=2,
                              seq=64, batch=2)
    counters = sparse.RouteCounters(4, CFG.n_experts, CPU)
    with pytest.raises(ValueError, match="counts no routes"):
        burnin.loss_fn(burnin.init_params(cfg, torch.Generator()
                                          .manual_seed(0), CPU),
                       (tokens, targets), cfg, counters=counters)


# ------------------------------------------------------------ positions

def _yarn_by_formula(d, theta, y):
    """transformers' ``_compute_yarn_parameters`` written out anew."""
    def dim_of(rot):
        return (d * math.log(y["original_max_position_embeddings"]
                             / (rot * 2 * math.pi))) / (2 * math.log(theta))

    low = max(math.floor(dim_of(y["beta_fast"])), 0)
    high = min(math.ceil(dim_of(y["beta_slow"])), d - 1)
    out = []
    for i in range(d // 2):
        extra = theta ** (-(2 * i) / d)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        out.append(extra / y["factor"] * ramp + extra * (1 - ramp))
    return torch.tensor(out, dtype=torch.float64), low, high


def test_yarn_frequencies_and_scale_follow_the_formula():
    inv, scale = sparse.rope_inv_freq(128, 500000.0, sparse.Yarn())
    want, low, high = _yarn_by_formula(128, 500000.0, YARN)
    assert torch.allclose(inv.double(), want, rtol=1e-6)
    # below the fast correction dimension the frequencies are the
    # default's, past the slow one a sixteenth of them
    plain, one = sparse.rope_inv_freq(128, 500000.0)
    assert one == 1.0 and 0 < low < high < 64
    assert torch.allclose(inv[:low], plain[:low])
    assert torch.allclose(inv[high:], plain[high:] / 16)
    assert scale == pytest.approx(0.1 * math.log(16) + 1)
    # the program's angles are f32 products, as transformers makes them,
    # the reference's f64: position 63 times a frequency whose f32 power
    # is off by about 1e-6 moves cos and sin by up to ~1e-4
    for kind in ("sliding", "full"):
        cos, sin = sparse.rope_tables(CFG, kind, 64, CPU)
        rcos, rsin = ref.rope(_model(CFG), kind, 64, CPU)
        assert torch.allclose(cos, rcos, rtol=0, atol=3e-4)
        assert torch.allclose(sin, rsin, rtol=0, atol=3e-4)


# -------------------------------------------------------- the window

def _brute(q, k, v, do, window):
    """f32 attention by autograd over a brute-force mask: o, and dq, dk,
    dv for the cotangent ``do``."""
    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * q.shape[-1] ** -0.5
    i = torch.arange(q.shape[1])[:, None]
    j = torch.arange(q.shape[1])[None, :]
    seen = (j <= i) & ((i - j < window) if window else True)
    p = torch.softmax(s.masked_fill(~seen, float("-inf")), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return (o, *torch.autograd.grad(o, (qf, kf, vf), do.float()))


@pytest.mark.parametrize("window", [0, 1, 15, 16, 17, 64])
def test_plain_kernels_take_the_window(window):
    gen = torch.Generator().manual_seed(window)
    q, k, v, do = (torch.randn((2, 64, 2, 128), generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    scale = 128 ** -0.5
    o, lse = fa.flash_attention_with_lse(q, k, v, scale, window)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, scale, window)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, scale, window)
    want = _brute(q, k, v, do, window)
    # bf16 outputs: P rounded to bf16 before P V, results rounded once;
    # relative to the magnitude, or to 1 where that is 0 (window 1: each
    # query sees itself alone, so dq is 0)
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want):
        err = (got.float() - w).abs().max() / max(float(w.abs().max()), 1.0)
        assert err < 2e-2, (name, float(err))


def test_window_zero_and_window_past_the_sequence_are_causal():
    """The burn-in's forward is bit for bit what it was with the window
    left at 0, and a window as long as the sequence changes nothing."""
    cfg = burnin.BurninConfig(vocab=64, d_model=256, d_ff=256, n_heads=2,
                              seq=64, batch=2, attention="flash")
    params = burnin.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    tokens = torch.randint(0, 64, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    base = burnin.forward(params, tokens, cfg)
    for window in (0, 64, 1000):
        def attend(q, k, v, scale, window=window):
            return fa.flash_attention_reference(q, k, v, scale,
                                                window=window)
        orig = burnin.flash_attention
        try:
            burnin.flash_attention = attend
            assert torch.equal(burnin.forward(params, tokens, cfg), base)
        finally:
            burnin.flash_attention = orig


def test_window_is_checked():
    q = torch.zeros((1, 64, 1, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, 1.0, -1)


def test_the_cell_runs_the_published_widths():
    cell = harness.load_cell("mellum2-train-s8192")
    m, published = cell.model, cell.config["published"]
    assert (m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"],
            m["n_experts"], m["top_k"], m["d_expert"], m["vocab"],
            m["window"], m["context"], m["norm_eps"]) == (
        published["hidden_size"], published["num_attention_heads"],
        published["num_key_value_heads"], published["head_dim"],
        published["num_experts"], published["num_experts_per_tok"],
        published["moe_intermediate_size"], published["vocab_size"],
        published["sliding_window"], published["max_position_embeddings"],
        published["rms_norm_eps"])
    kinds = [t.split("_")[0] for t in published["layer_types"]]
    assert m["layer_types"] == kinds[:m["layers"]] == m["period"]
    full = published["rope_parameters"]["full_attention"]
    assert m["yarn"] == {k: full[k] for k in m["yarn"]}
    assert m["rope_theta"] == full["rope_theta"] == published[
        "rope_parameters"]["sliding_attention"]["rope_theta"]
    assert list(cell.config["reduced"]) == ["num_hidden_layers"]
    assert cell.config["num_hidden_layers"] == m["layers"] == 4
