"""The port's burn-in transformer (forward) against the JAX
reference: forward parity on every attention path and both parameter
dtypes, the weight carry-over, the knob guards, the attention selector
and the parameter initialisation.

Parameters come from the reference's ``init_params`` and cross through
numpy (``params_from_jax``); tokens are drawn with numpy from a seed, so
both packages see the same inputs.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cluster.workloads import burnin as ref
from tpu_cluster_torch.workloads import burnin as port

# d_head 128 so the flash path's kernel shape rules hold; seq two 64-row
# tiles, attn_block 64 so chunked walks two blocks.
TINY = dict(vocab=64, d_model=256, d_ff=512, n_heads=2, seq=128, batch=2,
            attn_block=64)

# bf16 path differences: both packages compute in bf16 with f32 scores
# and statistics, but round at different places (fused elementwise ops,
# GEMM reduction order), and a one-ulp bf16 difference at activations of
# magnitude ~1 propagates to logits of magnitude ~4. The repo's own
# chunked-vs-xla check uses the same bound (tests/test_workloads.py).
LOGIT_ATOL = 5e-2


def _to_port(cfg):
    return port.BurninConfig(**cfg.__dict__)


def _setup(param_dtype, seed=0):
    cfg = ref.BurninConfig(**TINY, param_dtype=param_dtype)
    params = ref.init_params(cfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (cfg.batch, cfg.seq)).astype(np.int32)
    return cfg, params, tokens


# (port attention, score dtype) -> the reference attention it is held to:
# the port's flash path runs its plain version on the CPU and is held here
# to the reference's materialised "xla" path (tests/test_torch_train.py
# holds it to the reference's own flash kernels, run in interpret mode).
PATHS = [("xla", "f32", "xla"), ("xla", "bf16", "xla"),
         ("chunked", "f32", "chunked"), ("flash", "f32", "xla")]


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("attention,score_dtype,ref_attention", PATHS)
def test_forward_matches_reference(attention, score_dtype, ref_attention,
                                   param_dtype):
    cfg, params, tokens = _setup(param_dtype)
    want = np.asarray(ref.forward(
        params, jnp.asarray(tokens),
        replace(cfg, attention=ref_attention, score_dtype=score_dtype)))
    tparams = port.params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, "cpu")
    got = port.forward(
        tparams, torch.from_numpy(tokens),
        replace(_to_port(cfg), attention=attention, score_dtype=score_dtype))
    assert got.dtype == torch.float32  # f32 logits, never rounded to bf16
    assert got.shape == (cfg.batch, cfg.seq, cfg.vocab)
    err = np.abs(got.numpy() - want).max()
    assert err < LOGIT_ATOL, (attention, score_dtype, param_dtype, err)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_params_from_jax_round_trip(param_dtype):
    cfg = ref.BurninConfig(**TINY, param_dtype=param_dtype)
    params = ref.init_params(cfg, jax.random.PRNGKey(3))
    host = {k: np.asarray(v) for k, v in params.items()}
    tparams = port.params_from_jax(host, "cpu")
    want_dtype = torch.bfloat16 if param_dtype == "bf16" else torch.float32
    assert list(tparams) == list(host)
    for name, arr in host.items():
        t = tparams[name]
        assert t.dtype == want_dtype and tuple(t.shape) == arr.shape
        # lossless both ways: the [in, out] layout and every bit survive
        np.testing.assert_array_equal(t.float().numpy(),
                                      arr.astype(np.float32))


BAD_KNOBS = [
    dict(attention="bogus"),
    dict(score_dtype="f16"),
    dict(param_dtype="f16"),
    dict(score_dtype="bf16", attention="chunked"),
    dict(score_dtype="bf16", attention="flash"),
    dict(remat="attn", attention="flash"),
    dict(remat="attn", attention="chunked"),
    dict(attention="chunked", attn_block=48),
]


@pytest.mark.parametrize("knobs", BAD_KNOBS)
def test_knob_guards_raise_with_reference_message(knobs):
    cfg = replace(ref.BurninConfig(**TINY), **knobs)
    params = ref.init_params(replace(cfg, param_dtype="f32"),
                             jax.random.PRNGKey(0))
    tokens = np.zeros((cfg.batch, cfg.seq), np.int32)
    with pytest.raises(ValueError) as want:
        ref.forward(params, jnp.asarray(tokens), cfg)
    tparams = port.params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, "cpu")
    with pytest.raises(ValueError) as got:
        port.forward(tparams, torch.from_numpy(tokens), _to_port(cfg))
    assert str(got.value) == str(want.value)


def test_init_params_rejects_unknown_param_dtype_like_reference():
    cfg = ref.BurninConfig(**TINY, param_dtype="fp8")
    with pytest.raises(ValueError) as want:
        ref.init_params(cfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as got:
        port.init_params(_to_port(cfg), torch.Generator(), "cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["standard_config", "bench_config"])
def test_reference_configurations_carry_over(name):
    assert getattr(port, name)().__dict__ == getattr(ref, name)().__dict__


def _selector_configs():
    """The configurations tests/test_shardbench.py drives the reference
    selector over, built around the port's crossover (the H100's)."""
    std = ref.standard_config()
    cross = port.FLASH_CROSSOVER_SEQ
    chunked = replace(std, attention="chunked", attn_block=128)
    return [
        replace(std, seq=cross), replace(std, seq=2 * cross),
        replace(std, seq=cross // 2),
        replace(std, n_heads=64, seq=cross),
        chunked, replace(chunked, seq=320), replace(chunked, seq=cross),
    ]


@pytest.mark.parametrize("cfg", _selector_configs(),
                         ids=lambda c: f"s{c.seq}h{c.n_heads}{c.attention}")
def test_select_attention_agrees_with_reference(cfg, monkeypatch):
    # the reference's rule at the port's constant: its selector reads the
    # module global when called
    monkeypatch.setattr(ref, "FLASH_CROSSOVER_SEQ", port.FLASH_CROSSOVER_SEQ)
    pcfg = _to_port(cfg)
    assert port.select_attention(pcfg, "cuda") == \
        ref.select_attention(cfg, "tpu")
    on_cpu = port.select_attention(pcfg, "cpu")
    assert on_cpu == ref.select_attention(cfg, "cpu")
    assert on_cpu != "flash"
    if cfg.attention == "xla":
        assert on_cpu == "xla"


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_init_params_matches_reference_shapes_dtypes_scales(param_dtype):
    cfg = ref.BurninConfig(**TINY, param_dtype=param_dtype)
    want = ref.init_params(cfg, jax.random.PRNGKey(0))
    got = port.init_params(_to_port(cfg), torch.Generator().manual_seed(0),
                           "cpu")
    want_dtype = torch.bfloat16 if param_dtype == "bf16" else torch.float32
    d, f = cfg.d_model, cfg.d_ff
    scales = {"embed": 0.02, "wq": d ** -0.5, "wk": d ** -0.5,
              "wv": d ** -0.5, "wo": d ** -0.5, "w1": d ** -0.5,
              "w2": f ** -0.5, "out": d ** -0.5}
    assert list(got) == list(want) == list(scales)
    for name, arr in want.items():
        t = got[name]
        assert tuple(t.shape) == arr.shape and t.dtype == want_dtype
        # >= 16k samples a tensor: the sample std is within 3% of the
        # scale (its standard error is under 0.6%)
        std = t.float().std().item()
        assert abs(std / scales[name] - 1) < 0.03, (name, std)
        assert abs(float(jnp.std(arr.astype(jnp.float32)))
                   / scales[name] - 1) < 0.03
