"""The port's own spans: the serving engine's iteration
(``telemetry.SERVING_SPANS``) and the training step
(``telemetry.TRAIN_SPANS``), off unless armed, and their clock: a span's
offsets converted by ``Tracer.wall_ns`` land on the torch profiler's
timeline.
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tpu_cluster_torch import telemetry
from tpu_cluster_torch.workloads import burnin, serving

TINY = dict(vocab=32, d_model=16, d_ff=32, n_heads=2, seq=16, slots=2)
PROMPTS = [(1, 2, 3), (5, 9, 11, 2, 7), (4,)]
(ITERATION, ADMIT, GAUGES, UPLOAD, DISPATCH, SYNC, EMIT,
 PARK) = telemetry.SERVING_SPANS


def engine(tel, spans, **kw):
    return serving.InferenceEngine(serving.ServingConfig(**{**TINY, **kw}),
                                   telemetry=tel, device="cpu", spans=spans)


def serve(eng, steps=12):
    reqs = [eng.submit(p, max_new_tokens=3 + i)
            for i, p in enumerate(PROMPTS)]
    for _ in range(steps):
        eng.step()
    return reqs


def names(spans):
    return [s.name for s in spans]


def test_spans_off_build_no_span(monkeypatch):
    def no_span(*args, **kwargs):
        raise AssertionError("a Span was built with spans off")

    monkeypatch.setattr(telemetry, "Span", no_span)
    tel = telemetry.Telemetry()
    reqs = serve(engine(tel, spans=False))
    assert all(r.status == serving.STATUS_OK for r in reqs)
    assert tel.tracer.roots == []


def test_spans_need_a_telemetry():
    with pytest.raises(ValueError):
        engine(None, spans=True)


def test_each_step_is_one_iteration_with_its_parts_in_order():
    tel = telemetry.Telemetry()
    eng = engine(tel, spans=True)
    reqs = serve(eng)
    plain = serve(engine(telemetry.Telemetry(), spans=False))
    assert [r.tokens for r in reqs] == [r.tokens for r in plain]

    roots = tel.tracer.roots
    assert names(roots) == [ITERATION] * 12
    decoding = [s for s in roots if s.args["seated"] > 0]
    assert len(decoding) == eng.iterations
    for span in decoding:
        assert names(span.children) == [ADMIT, GAUGES, UPLOAD, DISPATCH,
                                        SYNC, EMIT]
        bounds = [(c.start_s, c.end_s) for c in span.children]
        assert all(a[1] <= b[0] for a, b in zip(bounds, bounds[1:]))
        assert span.start_s <= bounds[0][0] and bounds[-1][1] <= span.end_s
    for span in roots[len(decoding):]:
        assert span.args["seated"] == 0
        assert names(span.children) == [ADMIT, GAUGES]
    assert sum(s.args["admitted"] for s in roots) == len(PROMPTS)
    assert sum(s.args["evicted"] for s in roots) == len(PROMPTS)
    assert sum(s.args["seated"] for s in roots) == eng.decoded_tokens


def test_dispatch_spans_carry_the_tail_rows():
    """Every decode's dispatch span says how many rows the block's tail
    and the LM head ran on: one a slot, seated or not."""
    tel = telemetry.Telemetry()
    eng = engine(tel, spans=True)
    serve(eng)
    dispatches = [c for s in tel.tracer.roots for c in s.children
                  if c.name == DISPATCH]
    assert len(dispatches) == eng.iterations > 0
    assert all(c.args["tail_rows"] == TINY["slots"] for c in dispatches)


def test_a_parked_engine_leaves_park_spans():
    tel = telemetry.Telemetry()
    eng = engine(tel, spans=True).start()
    try:
        deadline = time.monotonic() + 10.0
        while PARK not in names(tel.tracer.roots) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    assert eng._thread is not None and not eng._thread.is_alive()
    parks = [s for s in tel.tracer.roots if s.name == PARK]
    assert parks and all(s.children == [] for s in parks)


def test_train_step_spans_leave_the_step_unchanged():
    cfg = burnin.BurninConfig(vocab=64, d_model=32, d_ff=64, n_heads=2,
                              seq=16, batch=2)
    params, batch = burnin.seeded_inputs(cfg, torch.device("cpu"))
    tel = telemetry.Telemetry()
    got, got_loss = burnin.train_step(params, batch, cfg, telemetry=tel)
    want, want_loss = burnin.train_step(params, batch, cfg)
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(got[k], want[k]) for k in want)
    step, loss_and_grads, sgd_update = telemetry.TRAIN_SPANS
    (root,) = tel.tracer.roots
    assert root.name == step
    assert names(root.children) == [loss_and_grads, sgd_update]


def test_span_offsets_land_on_the_wall_clock():
    tel = telemetry.Telemetry()
    before = time.time_ns()
    with tel.span("outer", "test") as span:
        time.sleep(0.002)
    after = time.time_ns()
    start, end = (tel.tracer.wall_ns(span.start_s),
                  tel.tracer.wall_ns(span.end_s))
    assert before - 20_000 <= start < end <= after + 20_000
    assert end - start >= 2_000_000


def test_span_offsets_land_on_the_profiler_clock():
    """A profiler range opened inside a span lands within 200 us of the
    span's bounds, in the tightest of three profiler runs: each run
    calibrates the profiler's clock against the wall clock as it starts,
    and a loaded host can throw that off by some hundred us."""
    gaps = []
    for _ in range(3):
        tel = telemetry.Telemetry()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm"):
                pass
            tel.tracer.reanchor()
            with tel.span("outer", "test") as span:
                with record_function("inner"):
                    time.sleep(0.005)
        (inner,) = [e for e in prof.profiler.kineto_results.events()
                    if e.name() == "inner"]
        start = inner.start_ns() - tel.tracer.wall_ns(span.start_s)
        end = tel.tracer.wall_ns(span.end_s) - (inner.start_ns()
                                                + inner.duration_ns())
        gaps.append(max(abs(start), abs(end)))
    assert min(gaps) < 200_000
