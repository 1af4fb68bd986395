"""Open-loop traffic generator for the serving path.

The port's own copy of ``tpu_cluster/workloads/loadgen.py`` (stdlib
only): the port imports nothing of the reference package.

Closed-loop load tests lie about tail latency: a stalled server slows
the generator down with it, so the arrival rate sags exactly when the
system is most stressed and the measured p99 flatters the server.
This generator is OPEN-LOOP — arrivals follow a precomputed schedule
(stepped QPS profiles) regardless of completions, the methodology the
tail-at-scale literature assumes — plus the same hedging discipline the
apiserver client uses ("The Tail at Scale", Dean & Barroso): if a
request has no reply after ``hedge_after_s``, fire a duplicate at the
NEXT replica and take whichever answers first. Greedy decoding is
deterministic, so duplicated generation is an idempotent read and the
loser is simply discarded.

Senders are pluggable callables so the same generator drives in-process
engines (the bench's CB-vs-static comparison) and real HTTP frontends
(the CI serving e2e): see :func:`engine_sender` / :func:`http_sender`.
Everything here is stdlib-only and clusterless.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# A sender issues one generation request (prompt, max_new_tokens,
# deadline_s) against one replica and returns (status, tokens_decoded).
# It must be blocking and safe to call from multiple threads.
Sender = Callable[[Tuple[int, ...], int, float], Tuple[str, int]]


@dataclass(frozen=True)
class Step:
    """One rung of a stepped QPS profile."""

    qps: float
    duration_s: float


def arrival_times(steps: Sequence[Step]) -> List[float]:
    """Deterministic open-loop schedule: evenly spaced arrivals within
    each step, offsets relative to profile start."""
    out: List[float] = []
    base = 0.0
    for step in steps:
        if step.qps > 0:
            n = max(1, int(round(step.qps * step.duration_s)))
            gap = step.duration_s / n
            out.extend(base + i * gap for i in range(n))
        base += step.duration_s
    return out


@dataclass
class Outcome:
    """One request as the CLIENT saw it (hedged pairs collapse to the
    winning attempt)."""

    start: float
    latency_s: float
    status: str
    tokens: int
    replica: int
    hedged: bool


def quantile(values: Sequence[float], q: float) -> float:
    """Exact (nearest-rank, linear-interpolated) quantile of raw
    samples — the client-side truth the server histograms approximate."""
    if not values:
        return 0.0
    ordered = sorted(values)
    if len(ordered) == 1:
        return ordered[0]
    idx = q * (len(ordered) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(ordered) - 1)
    frac = idx - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


@dataclass
class Report:
    """The generator's verdict over one profile run."""

    outcomes: List[Outcome] = field(default_factory=list)
    wall_s: float = 0.0
    hedges_fired: int = 0

    def _count(self, status: str) -> int:
        return sum(1 for o in self.outcomes if o.status == status)

    @property
    def ok(self) -> int:
        return self._count("ok")

    @property
    def deadline_exceeded(self) -> int:
        return self._count("deadline")

    @property
    def rejected(self) -> int:
        return self._count("rejected")

    @property
    def errors(self) -> int:
        return len(self.outcomes) - self.ok - self.deadline_exceeded \
            - self.rejected

    def latency_ms(self, q: float) -> float:
        return 1e3 * quantile(
            [o.latency_s for o in self.outcomes if o.status == "ok"], q)

    @property
    def tokens_per_s(self) -> float:
        total = sum(o.tokens for o in self.outcomes if o.status == "ok")
        return total / self.wall_s if self.wall_s > 0 else 0.0

    def summary(self) -> Dict[str, Any]:
        return {
            "requests": len(self.outcomes), "ok": self.ok,
            "deadline": self.deadline_exceeded, "rejected": self.rejected,
            "errors": self.errors, "hedges": self.hedges_fired,
            "p50_ms": round(self.latency_ms(0.50), 3),
            "p99_ms": round(self.latency_ms(0.99), 3),
            "tokens_per_s": round(self.tokens_per_s, 3),
            "wall_s": round(self.wall_s, 6),
        }


class LoadGenerator:
    """Fire a stepped profile at one or more replicas, open-loop.

    The dispatcher thread (the caller of :meth:`run`) sleeps to each
    scheduled arrival and hands the request to a worker thread — it
    never waits for completions, so a slow server cannot throttle the
    offered load. With ``pace=False`` the whole schedule fires
    immediately (the bench's compressed-time replay: identical arrival
    ORDER, wall-clock pacing elided)."""

    def __init__(self, senders: Sequence[Sender], steps: Sequence[Step],
                 prompt: Tuple[int, ...] = (1, 2, 3, 4),
                 max_new_tokens: int = 8, deadline_s: float = 10.0,
                 hedge_after_s: Optional[float] = None,
                 pace: bool = True,
                 prompt_for: Optional[
                     Callable[[int], Tuple[int, ...]]] = None,
                 tokens_for: Optional[Callable[[int], int]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        if not senders:
            raise ValueError("loadgen needs at least one sender")
        self.senders = list(senders)  # thread-owned (read-only after init)
        self.steps = list(steps)  # thread-owned (read-only after init)
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.deadline_s = deadline_s
        self.hedge_after_s = hedge_after_s
        self.pace = pace
        self.prompt_for = prompt_for
        self.tokens_for = tokens_for
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._outcomes: List[Tuple[int, Outcome]] = []  # guarded-by: _lock
        self._hedges = 0  # guarded-by: _lock

    def run(self) -> Report:
        schedule = arrival_times(self.steps)
        t0 = self._clock()
        workers: List[threading.Thread] = []
        for i, offset in enumerate(schedule):
            if self.pace:
                delay = (t0 + offset) - self._clock()
                if delay > 0:
                    self._sleep(delay)
            th = threading.Thread(target=self._fire, args=(i,),
                                  daemon=True, name=f"loadgen-{i}")
            th.start()
            workers.append(th)
        join_deadline = time.monotonic() + self.deadline_s + 30.0
        for th in workers:
            th.join(timeout=max(0.0, join_deadline - time.monotonic()))
        wall = self._clock() - t0
        with self._lock:
            ordered = [o for _, o in sorted(self._outcomes,
                                            key=lambda p: p[0])]
            hedges = self._hedges
        return Report(outcomes=ordered, wall_s=wall, hedges_fired=hedges)

    # ------------------------------------------------------------ worker

    def _fire(self, i: int) -> None:
        prompt = self.prompt_for(i) if self.prompt_for else self.prompt
        want = self.tokens_for(i) if self.tokens_for else \
            self.max_new_tokens
        primary = i % len(self.senders)
        start = self._clock()
        done = threading.Event()
        winner: Dict[str, Any] = {}
        race = threading.Lock()

        def attempt(replica: int, hedged: bool) -> None:
            try:
                status, ntok = self.senders[replica](
                    prompt, want, self.deadline_s)
            except Exception:
                status, ntok = "error", 0
            with race:
                if not winner:
                    winner.update(status=status, tokens=ntok,
                                  replica=replica, hedged=hedged)
                    done.set()

        threading.Thread(target=attempt, args=(primary, False),
                         daemon=True).start()
        hedged_fired = False
        if self.hedge_after_s is not None and len(self.senders) > 1:
            if not done.wait(timeout=self.hedge_after_s):
                # primary is slow — duplicate the (idempotent) read at
                # the next replica; first answer wins, loser discarded.
                hedged_fired = True
                threading.Thread(
                    target=attempt,
                    args=((primary + 1) % len(self.senders), True),
                    daemon=True).start()
        done.wait(timeout=self.deadline_s + 30.0)
        with race:
            got = dict(winner) if winner else {
                "status": "error", "tokens": 0,
                "replica": primary, "hedged": False}
        out = Outcome(start=start, latency_s=self._clock() - start,
                      status=str(got["status"]),
                      tokens=int(got["tokens"]),
                      replica=int(got["replica"]),
                      hedged=bool(got["hedged"]))
        with self._lock:
            self._outcomes.append((i, out))
            if hedged_fired:
                self._hedges += 1


# ---------------------------------------------------------------------------
# Senders.


def engine_sender(engine: Any) -> Sender:
    """In-process sender: submit to an ``InferenceEngine`` and block on
    its completion event (bench / unit-test path)."""

    def send(prompt: Tuple[int, ...], max_new_tokens: int,
             deadline_s: float) -> Tuple[str, int]:
        req = engine.submit(prompt, max_new_tokens=max_new_tokens,
                            deadline_s=deadline_s)
        req.done.wait(timeout=deadline_s + 30.0)
        return (req.status or "deadline", len(req.tokens))

    return send


def http_sender(url: str) -> Sender:
    """HTTP sender against a :class:`ServingServer` frontend (CI e2e)."""
    import json
    import urllib.error
    import urllib.request

    def send(prompt: Tuple[int, ...], max_new_tokens: int,
             deadline_s: float) -> Tuple[str, int]:
        body = json.dumps({
            "prompt": list(prompt), "max_new_tokens": max_new_tokens,
            "deadline_s": deadline_s}).encode()
        req = urllib.request.Request(
            url.rstrip("/") + "/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=deadline_s + 30.0) as resp:
                doc = json.loads(resp.read().decode())
        except urllib.error.HTTPError as err:
            try:
                doc = json.loads(err.read().decode())
            except ValueError:
                return ("error", 0)
        except (urllib.error.URLError, OSError, ValueError):
            return ("error", 0)
        return (str(doc.get("status", "error")),
                len(doc.get("tokens", ())))

    return send
