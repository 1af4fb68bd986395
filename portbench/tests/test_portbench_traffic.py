"""The serving traffic: reproducible from the seed, the same work for
every seed, and tails timed from when each request was due."""

from __future__ import annotations

import math

import numpy as np
import pytest

from portbench import harness, traffic
from portbench.stats import MISS, percentile

OPEN = harness.load_cell("gptj6b-serve-poisson").traffic
SATURATED = harness.load_cell("mpt7b8k-serve-offline").traffic
BIG_SEED = 2 ** 31 + 5


@pytest.mark.parametrize("mix", [OPEN, SATURATED], ids=["open", "saturated"])
def test_plan_reproducible_from_the_seed(mix):
    a = traffic.plan(mix, BIG_SEED, 30, 50400, 8192)
    b = traffic.plan(mix, BIG_SEED, 30, 50400, 8192)
    c = traffic.plan(mix, BIG_SEED + 1, 30, 50400, 8192)
    assert a == b
    # the same requests at the same times for every seed; the ids differ
    assert [(p.at, len(p.prompt), p.max_new) for p in a] == \
        [(p.at, len(p.prompt), p.max_new) for p in c]
    assert [p.prompt for p in a] != [p.prompt for p in c]


def test_another_rate_scales_the_same_trace():
    """The knee's sweep changes the rate alone: the same requests in the
    same order, the gaps scaled."""
    rate = OPEN["arrivals"]["rate_per_s"]
    a = traffic.plan(OPEN, 5, 30, 50400, 2048)
    fast = dict(OPEN, arrivals=dict(OPEN["arrivals"], rate_per_s=2 * rate))
    b = traffic.plan(fast, 5, 30, 50400, 2048)
    assert len(b) > len(a)
    assert [(len(p.prompt), p.max_new) for p in a] == \
        [(len(p.prompt), p.max_new) for p in b[:len(a)]]
    assert [2 * p.at for p in b[:len(a)]] == pytest.approx([p.at for p in a])


def test_poisson_schedule():
    plan = traffic.plan(OPEN, 7, 30, 50400, 2048)
    rate = OPEN["arrivals"]["rate_per_s"]
    span = OPEN["arrivals"]["lead_in_s"] + 30 + OPEN["drain_s"]
    assert len(plan) == math.ceil(rate * span)
    gaps = np.diff([0.0] + [p.at for p in plan])
    assert gaps.min() >= 0
    assert abs(gaps.mean() * rate - 1) < 0.1
    # exponential gaps: the spread equals the mean
    assert abs(gaps.std() / gaps.mean() - 1) < 0.15


def test_bursty_schedule():
    mix = dict(OPEN, arrivals=dict(OPEN["arrivals"], process="gamma", cv=3.0))
    gaps = np.diff([0.0] + [p.at for p in traffic.plan(mix, 9, 600, 100,
                                                        2048)])
    rate = OPEN["arrivals"]["rate_per_s"]
    assert abs(gaps.mean() * rate - 1) < 0.1
    assert abs(gaps.std() / gaps.mean() - 3) < 0.5


@pytest.mark.parametrize("mix", [OPEN, SATURATED], ids=["open", "saturated"])
def test_lengths_within_their_clips(mix):
    plan = traffic.plan(mix, 3, 30, 100, 8192)
    for p in plan:
        assert mix["prompt"]["min"] <= len(p.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= p.max_new <= mix["output"]["max"]
        assert all(0 <= t < 100 for t in p.prompt)


def test_prompt_and_output_must_fit_the_context():
    with pytest.raises(ValueError, match="context"):
        traffic.plan(OPEN, 1, 1, 100, 1024)


def test_nearest_rank_percentile():
    assert percentile([3, 1, 2, 4], 50) == 2
    assert percentile(range(1, 101), 95) == 95
    assert percentile([1.0] * 95 + [MISS] * 5, 95) == 1.0
    assert percentile([1.0] * 94 + [MISS] * 6, 95) == MISS
    assert percentile([], 95) is None


def _row(due, first, status="ok", admitted=None, finished=None, tokens=5):
    if finished is None and first is not None:
        finished = first + 0.1 * (tokens - 1)
    return {"due": due, "submitted": due, "admitted": admitted,
            "first": first, "finished": finished, "status": status,
            "tokens": tokens, "prompt": 8}


def test_ttft_counts_from_due_and_a_failure_is_a_miss(monkeypatch):
    ttft = harness.reader("ttft_p95_ms")
    rows = [_row(10.0 + i, 10.5 + i) for i in range(19)]
    rec = {"mode": "open", "judged": rows}
    assert ttft(rec) == pytest.approx(500.0)
    # late sending does not hide the wait: timed from when it was due
    rows[0] = dict(rows[0], submitted=12.0, first=13.0)
    assert ttft(rec) == pytest.approx(3000.0)
    # two failures among 20 push the p95 onto a miss
    rec["judged"] = rows + [_row(40.0, None, status="rejected")]
    assert ttft(rec) == pytest.approx(3000.0)
    rec["judged"] = rows + [_row(40.0, None, status="rejected"),
                            _row(41.0, 41.2, status="deadline")]
    assert math.isinf(ttft(rec))
    # a cell that reports it carries the miss on its line as a number
    monkeypatch.setattr(harness, "benchmark_metrics", lambda cell, section: [
        {"name": "ttft_p95_ms", "unit": "ms"}])
    assert harness.read_metrics("gptj6b-serve-poisson", "end_to_end",
                                rec)["ttft_p95_ms"][
        "value"] == harness.INF_VALUE_MS


def test_queue_wait_and_tpot():
    wait = harness.reader("queue_wait_p95_ms.online")
    tpot = harness.reader("tpot_p95_ms")
    rows = [_row(1.0, 1.5, admitted=1.2, finished=2.5, tokens=11)
            for _ in range(10)]
    rec = {"mode": "open", "judged": rows + [_row(2.0, None, "deadline")]}
    assert tpot(rec) == pytest.approx(100.0)
    assert math.isinf(wait(rec))
    assert wait({"mode": "open", "judged": rows}) == pytest.approx(200.0)
