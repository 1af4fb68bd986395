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
