"""The port's serving engine: parity with the JAX engine, and the
reference's scheduling pins replayed on the port (tests/test_serving.py).

Engine parity: both engines serve one prompt set with the same weights —
the reference's ``init_params`` at ``PRNGKey(0)`` (what its engine draws)
carried into the port through the ``_ensure_model`` seam. Greedy tokens
are compared where the decision is well-conditioned, and the
teacher-forced logits of every decode iteration within a bf16 bound.

The scheduling pins drive ``InferenceEngine.step`` directly on the CPU
(no engine thread), so every admission/eviction interleaving is
deterministic.
"""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_cluster.workloads import burnin as ref_burnin
from tpu_cluster.workloads import serving as ref_serving
from tpu_cluster_torch import telemetry
from tpu_cluster_torch.workloads import burnin, loadgen, serving

TINY = dict(vocab=32, d_model=16, d_ff=32, n_heads=2, seq=16)

# Same bf16 path-difference bound as tests/test_torch_burnin.py.
LOGIT_ATOL = 5e-2


def tiny_engine(clock=time.monotonic, tel=None, **kw):
    merged = {**TINY, "slots": 2, **kw}
    return serving.InferenceEngine(serving.ServingConfig(**merged),
                                   telemetry=tel, clock=clock, device="cpu")


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# ------------------------------------------------------ engine parity

PARITY = dict(vocab=64, d_model=64, d_ff=128, n_heads=2, seq=32, slots=2,
              max_new_tokens=6)
PROMPTS = [(1, 2, 3), (5, 9, 11, 2, 7), (40,), (3,) * 8, (60, 61, 62, 63)]


def _reference_params():
    mcfg = ref_burnin.BurninConfig(
        vocab=PARITY["vocab"], d_model=PARITY["d_model"],
        d_ff=PARITY["d_ff"], n_heads=PARITY["n_heads"], seq=PARITY["seq"],
        batch=PARITY["slots"], param_dtype="bf16")
    params = ref_burnin.init_params(mcfg, jax.random.PRNGKey(0))
    return mcfg, params


class CarriedEngine(serving.InferenceEngine):
    """The port's engine serving carried-over reference weights."""

    def __init__(self, cfg, np_params):
        super().__init__(cfg, device="cpu")
        self._np_params = np_params

    def _ensure_model(self):
        if self._model is None:
            params = burnin.params_from_jax(self._np_params, self.device)
            self._tokens_host = np.zeros((self.cfg.slots, self.cfg.seq),
                                         dtype=np.int32)
            self._model = (params, serving.make_decode(
                self.model_config(), self.device), np)
        return self._model


def _serve(engine):
    reqs = [engine.submit(p) for p in PROMPTS]
    engine.drain()
    assert all(r.status == serving.STATUS_OK for r in reqs)
    return [list(r.tokens) for r in reqs]


def test_engine_matches_reference_engine():
    cfg_kw = dict(PARITY)
    mcfg, params = _reference_params()
    ref_tokens = _serve(ref_serving.InferenceEngine(
        ref_serving.ServingConfig(**cfg_kw)))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    port_engine = CarriedEngine(serving.ServingConfig(**cfg_kw), np_params)
    port_tokens = _serve(port_engine)
    port_mcfg = port_engine.model_config()
    assert port_mcfg.attention == "xla" and port_mcfg.param_dtype == "bf16"
    tparams = burnin.params_from_jax(np_params, "cpu")

    checked = 0
    for prompt, want, got in zip(PROMPTS, ref_tokens, port_tokens):
        assert len(got) == len(want) == PARITY["max_new_tokens"]
        # teacher forcing: the reference's history in a zero-padded slot
        # row, the logits at each decode iteration's position
        row = np.zeros((1, PARITY["seq"]), np.int32)
        seq = list(prompt) + want[:-1]
        row[0, :len(seq)] = seq
        positions = [len(prompt) - 1 + i for i in range(len(want))]
        ref_logits = np.asarray(ref_burnin.forward(
            params, jnp.asarray(row), mcfg))[0, positions]
        with torch.inference_mode():
            port_logits = burnin.forward(
                tparams, torch.from_numpy(row), port_mcfg)[0, positions]
        port_logits = port_logits.numpy()
        err = np.abs(port_logits - ref_logits).max()
        assert err < LOGIT_ATOL, err
        # greedy decisions, wherever the reference's top-2 margin is wider
        # than the two packages can disagree by
        top2 = np.sort(ref_logits, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        for i, tok in enumerate(want):
            if margin[i] > 2 * LOGIT_ATOL:
                assert int(port_logits[i].argmax()) == tok
                checked += 1
        # the served streams agree up to the first ill-conditioned step
        first_close = next((i for i in range(len(want))
                            if margin[i] <= 2 * LOGIT_ATOL), len(want))
        assert got[:first_close] == want[:first_close]
    assert checked >= len(PROMPTS)  # the check is not vacuous


def test_decode_runs_the_tail_and_head_on_one_row_a_slot(monkeypatch):
    """One step with every slot seated: the LM head sees ``slots`` rows,
    not the ``slots * seq`` of the whole buffer, and the tokens are the
    greedy picks of the full forward at each slot's position."""
    seen = []
    head = burnin.lm_head

    def counting(y, w):
        seen.append(y.shape[:-1].numel())
        return head(y, w)

    monkeypatch.setattr(burnin, "lm_head", counting)
    eng = tiny_engine(slots=3)
    prompts = [(1, 2, 3), (5, 9, 11, 2, 7), (4,)]
    reqs = [eng.submit(p, max_new_tokens=2) for p in prompts]
    assert eng.step() == 3
    assert seen == [3]

    params, _, _ = eng._ensure_model()
    row = np.zeros((3, TINY["seq"]), np.int32)
    for i, p in enumerate(prompts):
        row[i, :len(p)] = p
    with torch.inference_mode():
        full = burnin.forward(params, torch.from_numpy(row),
                              eng.model_config())
    last = [len(p) - 1 for p in prompts]
    picks = full[torch.arange(3), torch.tensor(last)].argmax(-1)
    assert [r.tokens for r in reqs] == [[int(t)] for t in picks]


# ------------------------------------------------------ the K/V cache


def _record_decode(monkeypatch):
    """Every decode call's buffer, positions, ids and logits: the engine's
    decode wrapped, the logits taken from ``burnin.block_tail``."""
    calls, tails = [], []
    make, tail = serving.make_decode, burnin.block_tail

    def block_tail(*args, **kw):
        tails.append(tail(*args, **kw))
        return tails[-1]

    def wrapped(mcfg, device, **kw):
        decode = make(mcfg, device, **kw)

        def run(params, tokens, pos):
            ids = decode(params, tokens, pos)
            calls.append((params, tokens.copy(), np.array(pos), ids,
                          tails[-1]))
            return ids
        return run

    monkeypatch.setattr(burnin, "block_tail", block_tail)
    monkeypatch.setattr(serving, "make_decode", wrapped)
    return calls


def _uncached(params, mcfg, tokens, pos):
    with torch.inference_mode():
        return burnin.forward(params, torch.from_numpy(tokens), mcfg,
                              at=torch.from_numpy(np.asarray(pos)).long())


def test_cached_decode_matches_the_uncached_forward(monkeypatch):
    """Through mid-batch admission and eviction, every iteration's tokens
    are the greedy picks of the whole-buffer forward at each slot's
    position, and its logits agree with that forward's."""
    calls = _record_decode(monkeypatch)
    eng = tiny_engine(slots=2)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in
            [((1, 2, 3), 5), ((5, 9, 11, 2, 7), 2), ((4,), 6),
             ((3, 1, 2, 8, 8, 8), 3), ((1, 2, 3, 4), 4)]]
    eng.drain()
    assert all(r.status == serving.STATUS_OK for r in reqs)
    mcfg = eng.model_config()
    assert len(calls) == eng.iterations > len(reqs)
    for params, tokens, pos, ids, logits in calls:
        want = _uncached(params, mcfg, tokens, pos)
        assert (logits - want).abs().max().item() < LOGIT_ATOL
        assert ids.tolist() == want.argmax(-1).tolist()


def _dispatch_rows(tel):
    """(projected_rows, cached_rows) of each dispatch span that carries
    them (a call that raised does not), in order."""
    spans = sorted((s for s in tel.tracer.walk()
                    if s.name == serving._DISPATCH
                    and "projected_rows" in s.args), key=lambda s: s.start_s)
    return [(s.args["projected_rows"], s.args["cached_rows"]) for s in spans]


def test_projected_rows_count_what_the_cache_misses():
    """A first call projects every prompt row; a continuing slot adds one
    row; a slot reseated with a prompt that shares k tokens with the last
    one adds its length less k; the rest is attended from the cache."""
    tel = telemetry.Telemetry()
    eng = tiny_engine(slots=2)
    params, _, _ = eng._ensure_model()
    decode = serving.make_decode(eng.model_config(), eng.device,
                                 telemetry=tel)
    tokens = np.zeros((2, TINY["seq"]), np.int32)
    a, b = [3, 1, 4, 1, 5, 9], [2, 7, 1, 8]
    tokens[0, :6], tokens[1, :4] = a, b
    pos = np.array([5, 3], np.int32)
    ids = decode(params, tokens, pos)
    tokens[[0, 1], pos + 1] = ids
    pos += 1
    decode(params, tokens, pos)
    c = [3, 1, 4, 2, 2, 2, 2, 2]             # shares 3 tokens with a
    tokens[0, :] = 0
    tokens[0, :8] = c
    pos = np.array([7, pos[1] + 1], np.int32)
    decode(params, tokens, pos)
    assert _dispatch_rows(tel) == [(6 + 4, 0), (1 + 1, 6 + 4),
                                   ((8 - 3) + 1, 3 + 5)]


def test_a_token_changed_behind_pos_is_projected_again(monkeypatch):
    """A token altered behind a slot's position is projected again from
    its position on, and the logits are the uncached forward's; with the
    stale rows kept they would not be."""
    tel = telemetry.Telemetry()
    eng = tiny_engine(slots=2)
    mcfg = eng.model_config()
    params, _, _ = eng._ensure_model()
    decode = serving.make_decode(mcfg, eng.device, telemetry=tel)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, TINY["vocab"], (2, TINY["seq"])).astype(np.int32)
    pos = np.array([10, 12], np.int32)
    decode(params, tokens, pos)
    before = _uncached(params, mcfg, tokens, pos)
    tokens[0, 4] = (tokens[0, 4] + 5) % TINY["vocab"]
    tails = []
    tail = burnin.block_tail
    monkeypatch.setattr(burnin, "block_tail",
                        lambda *a: tails.append(tail(*a)) or tails[-1])
    ids = decode(params, tokens, pos)
    want = _uncached(params, mcfg, tokens, pos)
    assert _dispatch_rows(tel)[-1] == ((10 - 4 + 1) + 1, 4 + 12)
    assert (tails[0] - want).abs().max().item() < LOGIT_ATOL
    assert ids.tolist() == want.argmax(-1).tolist()
    # the altered token moved slot 0's logits, not slot 1's
    assert (want[0] - before[0]).abs().max().item() > 4 * LOGIT_ATOL
    assert torch.equal(want[1], before[1])


def test_a_call_that_raises_leaves_its_rows_to_project(monkeypatch):
    """A call whose dispatch raises after the cache writes commits none of
    its rows to the mirror: the next call projects them again and gives
    the uncached forward's logits."""
    tel = telemetry.Telemetry()
    eng = tiny_engine(slots=2)
    mcfg = eng.model_config()
    params, _, _ = eng._ensure_model()
    decode = serving.make_decode(mcfg, eng.device, telemetry=tel)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, TINY["vocab"], (2, TINY["seq"])).astype(np.int32)
    pos = np.array([6, 9], np.int32)
    tail = burnin.block_tail

    def fail(*a):
        raise RuntimeError("planted")
    monkeypatch.setattr(burnin, "block_tail", fail)
    with pytest.raises(RuntimeError, match="planted"):
        decode(params, tokens, pos)
    tails = []
    monkeypatch.setattr(burnin, "block_tail",
                        lambda *a: tails.append(tail(*a)) or tails[-1])
    ids = decode(params, tokens, pos)
    want = _uncached(params, mcfg, tokens, pos)
    assert _dispatch_rows(tel) == [(7 + 10, 0)]
    assert (tails[0] - want).abs().max().item() < LOGIT_ATOL
    assert ids.tolist() == want.argmax(-1).tolist()


@pytest.mark.parametrize("device,d_model,n_heads,seq,want", [
    ("cuda", 1024, 8, 1000, "flash"),    # d_head 128, seq under K1's rule
    ("cuda", 4096, 16, 2048, "flash"),   # d_head 256
    ("cuda", 16, 2, 16, "xla"),          # d_head 8: not built for it
    ("cpu", 1024, 8, 2048, "xla"),       # the CPU: the plain version
])
def test_engine_picks_the_decode_kernel_by_device_and_width(
        device, d_model, n_heads, seq, want):
    """The engine's decode attention follows the decode kernel's own
    reach, the card and a head width it is built for, at any seq: not
    K1's crossover or tile rule. Nothing touches the card here."""
    cfg = serving.ServingConfig(vocab=64, d_model=d_model, d_ff=2 * d_model,
                                n_heads=n_heads, seq=seq, slots=2)
    eng = serving.InferenceEngine(cfg, device=device)
    assert eng.model_config().attention == want


def test_decode_refuses_weights_other_than_its_first():
    """The cache holds keys and values of the first call's parameters: a
    call with another parameters object raises; the same one runs on."""
    eng = tiny_engine(slots=2)
    mcfg = eng.model_config()
    params, _, _ = eng._ensure_model()
    decode = serving.make_decode(mcfg, eng.device)
    tokens = np.ones((2, TINY["seq"]), np.int32)
    pos = np.array([2, 3], np.int32)
    decode(params, tokens, pos)
    with pytest.raises(ValueError, match="first call's params"):
        decode(dict(params), tokens, pos)
    assert decode(params, tokens, pos).shape == (2,)


# ----------------------------------------------------------- admission


def test_submit_rejects_bad_requests_immediately():
    eng = tiny_engine(tel=telemetry.Telemetry())
    too_long = tuple(range(TINY["seq"]))
    for req in (eng.submit(too_long),
                eng.submit((), max_new_tokens=4),
                eng.submit((1, 2), max_new_tokens=0)):
        assert req.status == serving.STATUS_REJECTED
        assert req.done.is_set()
    assert eng.queue_depth() == 0
    counts = eng.telemetry.metrics.render()
    assert 'tpu_serving_requests_total{code="503"} 3' in counts


def test_submit_rejects_when_queue_full():
    eng = tiny_engine(max_queue=1)
    first = eng.submit((1, 2), max_new_tokens=2)
    second = eng.submit((1, 2), max_new_tokens=2)
    assert first.status == ""
    assert second.status == serving.STATUS_REJECTED
    assert eng.queue_depth() == 1


def test_continuous_batching_admits_into_running_batch():
    eng = tiny_engine(slots=2)
    a = eng.submit((1, 2), max_new_tokens=8)
    assert eng.step() == 1
    b = eng.submit((3, 4), max_new_tokens=2)
    assert eng.step() == 2  # b seated MID-BATCH, no barrier
    assert a.tokens and b.tokens
    eng.drain()
    assert a.status == serving.STATUS_OK and len(a.tokens) == 8
    assert b.status == serving.STATUS_OK and len(b.tokens) == 2


def test_mid_batch_eviction_frees_slot_for_queued_request():
    eng = tiny_engine(slots=2, tel=telemetry.Telemetry())
    short = eng.submit((1, 2), max_new_tokens=2)
    long = eng.submit((3, 4), max_new_tokens=10)
    waiter = eng.submit((5, 6), max_new_tokens=2)
    assert eng.step() == 2
    assert eng.step() == 2  # short finishes HERE, slot evicted mid-batch
    assert short.status == serving.STATUS_OK
    assert eng.step() == 2  # waiter seated while long still decodes
    assert waiter.admitted_ts is not None
    assert long.status == ""
    eng.drain()
    assert waiter.status == serving.STATUS_OK
    assert long.status == serving.STATUS_OK
    text = eng.telemetry.metrics.render()
    assert 'tpu_serving_evictions_total{cause="done"} 3' in text


def test_static_batching_barrier_holds_admission():
    eng = tiny_engine(slots=2, static_batching=True)
    a = eng.submit((1, 2), max_new_tokens=6)
    assert eng.step() == 1
    b = eng.submit((3, 4), max_new_tokens=2)
    while a.status == "":
        assert eng.step() == 1
    assert b.admitted_ts is None
    eng.drain()
    assert b.status == serving.STATUS_OK
    assert b.admitted_ts >= a.finished_ts


def test_cb_needs_fewer_iterations_than_static_for_same_traffic():
    lengths = [2, 8, 2, 8, 2, 8]
    runs = {}
    for static in (False, True):
        eng = tiny_engine(slots=2, static_batching=static)
        reqs = [eng.submit((1, 2, 3), max_new_tokens=n) for n in lengths]
        eng.drain()
        assert all(r.status == serving.STATUS_OK for r in reqs)
        assert [len(r.tokens) for r in reqs] == lengths
        runs[static] = (eng.iterations, eng.decoded_tokens)
    assert runs[False][1] == runs[True][1] == sum(lengths)
    assert runs[False][0] < runs[True][0], runs


# ----------------------------------------------------------- deadlines


def test_deadline_evicts_seated_request_mid_batch():
    clock = FakeClock()
    eng = tiny_engine(slots=2, clock=clock)
    keeper = eng.submit((1, 2), max_new_tokens=10, deadline_s=100.0)
    doomed = eng.submit((3, 4), max_new_tokens=10, deadline_s=0.5)
    assert eng.step() == 2
    clock.t += 1.0
    assert eng.step() == 2
    assert doomed.status == serving.STATUS_DEADLINE
    assert doomed.done.is_set()
    assert keeper.status == ""
    eng.drain()
    assert keeper.status == serving.STATUS_OK


def test_expired_queue_entry_dropped_at_admission():
    clock = FakeClock()
    eng = tiny_engine(slots=1, clock=clock)
    stale = eng.submit((1, 2), max_new_tokens=4, deadline_s=0.5)
    clock.t += 1.0
    assert eng.step() == 0
    assert stale.status == serving.STATUS_DEADLINE
    assert stale.admitted_ts is None


# ------------------------------------------------------- HTTP frontend


def test_http_frontend_round_trip_with_metrics_scrape():
    eng = tiny_engine(slots=2, tel=telemetry.Telemetry())
    with serving.ServingServer(eng) as srv:
        send = loadgen.http_sender(srv.url)
        status, ntok = send((1, 2, 3), 4, 10.0)
        assert (status, ntok) == (serving.STATUS_OK, 4)
        status, ntok = send(tuple(range(TINY["seq"])), 4, 10.0)
        assert (status, ntok) == (serving.STATUS_REJECTED, 0)
        with urllib.request.urlopen(srv.url + "/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read().decode()) == {"ok": True}
        with urllib.request.urlopen(srv.metrics_url, timeout=10) as resp:
            text = resp.read().decode()
        assert "tpu_serving_tokens_total 4" in text
        assert 'tpu_serving_requests_total{code="200"} 1' in text
        assert 'tpu_serving_requests_total{code="503"} 1' in text
        assert "tpu_serving_batch_slots 2" in text


def test_bench_arm_summary_shape():
    out = serving.bench_arm(static=False, slots=2, requests=4, device="cpu")
    assert out["ok"] == 4 and out["deadline"] == 0
    assert out["rejected"] == 0 and out["errors"] == 0
    assert out["tokens_per_s"] > 0
    assert out["p99_ms"] >= out["p50_ms"] > 0
    assert out["iterations"] >= 1 and out["occupancy"] > 0
