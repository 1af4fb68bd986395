"""Continuous-batching inference serving over the burn-in transformer,
on a torch device.

Port of ``tpu_cluster/workloads/serving.py`` with the same scheduling,
statuses and metrics; only the model seam differs. The engine is a
slot-based continuous-batching decode loop (the Orca scheduling shape):

- **Slot-based decode batching.** The decode batch is ``slots`` fixed
  positions over one static ``[slots, seq]`` token buffer; each
  iteration runs ONE full-sequence forward over it and advances every
  seated sequence by one token.
- **Iteration-level admission.** Between iterations finished sequences
  are evicted and queued requests are prefilled into the freed slots;
  ``static_batching=True`` is the control arm behind a batch-boundary
  barrier.
- **Attention selection.** The model config routes through
  ``burnin.select_attention`` with the engine's device type, so a
  long-context shape on CUDA runs the hand-written flash-attention
  kernel (one launch per decode iteration) and the CPU always gets the
  plain path.
- **Per-request deadlines**, enforced at queue admission, in the queue
  and mid-batch.
- **Observable.** ``tpu_serving_*`` families on the engine's registry
  plus ``tpu_duty_cycle_percent`` from a
  :class:`runtime_metrics.DutyCycleSampler` marking the decode
  dispatch..sync regions, served by ``metricsdb.MetricsServer``.

The stdlib HTTP frontend (:class:`ServingServer`) exposes
``POST /v1/generate`` with per-request ``deadline_s`` and a
``/healthz`` probe; handler threads block on the request's completion
event while the single engine thread owns all model state.

The engine runs on ``device`` (default ``torch.device("cuda")``; the CPU
only when the caller passes it). Nothing falls back: without a card the
default engine raises on its first step.

Concurrency: one leaf ``_lock`` (plus its Condition alias) guards the
queue and request bookkeeping; the token buffers and slot tables are
engine-thread-owned; the forward and every metrics write happen OUTSIDE
the lock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from collections import deque

import numpy as np
import torch

from .. import telemetry as _telemetry
from . import burnin, runtime_metrics

# Request terminal statuses (engine-internal vocabulary; the HTTP layer
# maps them onto response codes).
STATUS_OK = "ok"
STATUS_DEADLINE = "deadline"
STATUS_REJECTED = "rejected"

# Eviction causes (the SERVING_EVICTIONS_TOTAL label values).
EVICT_DONE = "done"
EVICT_DEADLINE = "deadline"


@dataclass(frozen=True)
class ServingConfig:
    """The serving operand's knobs: a (tiny by default) burnin-geometry
    model plus the continuous-batching schedule. ``seq`` is the static
    context window — prompt + generated tokens must fit in it."""

    vocab: int = 128
    d_model: int = 64
    d_ff: int = 128
    n_heads: int = 2
    seq: int = 48
    slots: int = 4
    max_new_tokens: int = 16
    default_deadline_s: float = 30.0
    max_queue: int = 256
    # admission policy: False = continuous batching (iteration-level
    # admission, mid-batch eviction); True = the static-batch CONTROL
    # ARM — whole batches admitted together behind a batch-boundary
    # barrier (finished sequences hold their slot until every batch
    # member finishes). Same decode step, same buffers; only the
    # scheduler differs, which is what makes the bench comparison fair.
    static_batching: bool = False


def make_decode(mcfg: burnin.BurninConfig,
                device: torch.device) -> Callable[..., np.ndarray]:
    """The one-iteration decode function ``decode(params, tokens, pos)``:
    greedy next token per slot at each slot's own position, from the
    ``[slots, seq]`` int32 host token buffer and the ``[slots]`` positions;
    returns the ``[slots]`` int32 next ids on the host.

    Causal attention means positions > pos cannot leak into the logits at
    pos, so pad tokens in the buffer tail are inert and every slot decodes
    independently of its batch neighbours (slot isolation — the property
    that makes mid-batch admission/eviction sound)."""

    def decode(params: Dict[str, torch.Tensor], tokens: np.ndarray,
               pos: np.ndarray) -> np.ndarray:
        # grad mode is thread-local: enter inference mode on the thread
        # that runs the decode (the engine thread)
        with torch.inference_mode():
            toks = torch.from_numpy(tokens).to(device)
            at = torch.from_numpy(pos).to(device=device, dtype=torch.long)
            logits = burnin.forward(params, toks, mcfg)
            last = logits[torch.arange(logits.shape[0], device=device), at]
            next_ids = torch.argmax(last, dim=-1).to(torch.int32)
            # the device-to-host copy is the iteration's sync
            return next_ids.cpu().numpy()

    return decode


@dataclass
class Request:
    """One in-flight generation request."""

    prompt: Tuple[int, ...]
    max_new_tokens: int
    deadline: float                 # absolute, engine clock
    submitted: float                # engine clock
    rid: int
    tokens: List[int] = field(default_factory=list)
    status: str = ""                # terminal: STATUS_* ("" = in flight)
    admitted_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    finished_ts: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)


class InferenceEngine:
    """The continuous-batching decode loop over the burnin transformer.

    ``submit()`` is the thread-safe ingress (HTTP handlers, loadgen);
    ``step()`` runs one decode iteration (admission → decode →
    eviction) and is driven either by :meth:`run` on a dedicated engine
    thread or directly by tests/bench. All model state (params, token
    buffer, slot table) is engine-thread-owned; the queue is the only
    shared structure.
    """

    def __init__(self, cfg: ServingConfig = ServingConfig(),
                 telemetry: Optional[_telemetry.Telemetry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device: burnin.DeviceLike = None) -> None:
        self.cfg = cfg
        self.device = burnin.resolve_device(device)
        self.telemetry = telemetry
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: Deque[Request] = deque()  # guarded-by: _lock
        self._queued = 0  # guarded-by: _lock (the queue-depth gauge)
        self._next_rid = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # ---- engine-thread-owned model + slot state ----
        self._model: Optional[Tuple[Any, Any, Any]] = None  # thread-owned
        self._slot_req: List[Optional[Request]] = [None] * cfg.slots  # thread-owned
        self._slot_pos: List[int] = [0] * cfg.slots  # thread-owned
        self._tokens_host: Any = None  # thread-owned ([slots, seq] int32)
        self._duty = runtime_metrics.DutyCycleSampler(window_s=5.0)  # thread-owned
        self.iterations = 0  # thread-owned (bench audit)
        self.decoded_tokens = 0  # thread-owned (bench audit)
        self._occupancy_samples: List[int] = []  # thread-owned (bench audit)

    # ------------------------------------------------------------ model

    def model_config(self) -> burnin.BurninConfig:
        """The served model: the serving geometry with bf16 parameters and
        the attention the selector picks for the engine's device."""
        cfg = self.cfg
        mcfg = burnin.BurninConfig(
            vocab=cfg.vocab, d_model=cfg.d_model, d_ff=cfg.d_ff,
            n_heads=cfg.n_heads, seq=cfg.seq, batch=cfg.slots,
            param_dtype="bf16")
        return replace(mcfg, attention=burnin.select_attention(
            mcfg, self.device.type))

    def _ensure_model(self) -> Tuple[Any, Any, Any]:
        """Build params + the one-iteration decode function lazily (first
        step), on the engine thread: bf16 parameters drawn on the engine's
        device from a generator seeded 0."""
        if self._model is not None:
            return self._model
        mcfg = self.model_config()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        params = burnin.init_params(mcfg, gen, self.device)
        self._tokens_host = np.zeros((self.cfg.slots, self.cfg.seq),
                                     dtype=np.int32)
        self._model = (params, make_decode(mcfg, self.device), np)
        return self._model

    # ------------------------------------------------------------ ingress

    def submit(self, prompt: Tuple[int, ...],
               max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request (any thread). An over-long prompt or a
        full queue rejects IMMEDIATELY (terminal before the engine ever
        sees it) — backpressure the caller can act on, not a silent
        deepening queue."""
        cfg = self.cfg
        now = self._clock()
        want = int(max_new_tokens if max_new_tokens is not None
                   else cfg.max_new_tokens)
        ttl = float(deadline_s if deadline_s is not None
                    else cfg.default_deadline_s)
        req = Request(prompt=tuple(int(t) % cfg.vocab for t in prompt),
                      max_new_tokens=want, deadline=now + ttl,
                      submitted=now, rid=0)
        reject = ""
        if not prompt or len(prompt) >= cfg.seq:
            reject = f"prompt length {len(prompt)} not in [1, {cfg.seq})"
        elif want < 1:
            reject = "max_new_tokens < 1"
        with self._lock:
            self._next_rid += 1
            req.rid = self._next_rid
            if not reject and self._queued >= cfg.max_queue:
                reject = f"queue full ({cfg.max_queue})"
            if not reject:
                self._queue.append(req)
                self._queued += 1
                self._cv.notify()
        if reject:
            req.status = STATUS_REJECTED
            req.finished_ts = now
            req.done.set()
            self._count_request(req)
        tel = self.telemetry
        if tel is not None:
            with self._lock:
                depth = self._queued
            tel.gauge(_telemetry.SERVING_QUEUE_DEPTH,
                      "requests queued for a decode slot"
                      ).set(float(depth))
        return req

    def queue_depth(self) -> int:
        with self._lock:
            return self._queued

    # ------------------------------------------------------------ engine

    def _active(self) -> int:
        return sum(1 for r in self._slot_req if r is not None)

    def _finish(self, slot: int, status: str, now: float,
                cause: str) -> None:
        """Terminal bookkeeping for a seated request + slot eviction —
        called mid-batch, which is the continuous-batching point."""
        req = self._slot_req[slot]
        assert req is not None
        req.status = status
        req.finished_ts = now
        self._slot_req[slot] = None
        req.done.set()
        self._count_request(req, cause=cause)

    def _count_request(self, req: Request,
                       cause: Optional[str] = None) -> None:
        tel = self.telemetry
        if tel is None:
            return
        code = {STATUS_OK: "200", STATUS_DEADLINE: "504",
                STATUS_REJECTED: "503"}.get(req.status, "500")
        tel.counter(_telemetry.SERVING_REQUESTS_TOTAL,
                    "generation requests by response code",
                    code=code).inc()
        if cause is not None:
            tel.counter(_telemetry.SERVING_EVICTIONS_TOTAL,
                        "decode-slot evictions by cause",
                        cause=cause).inc()
        end = req.finished_ts if req.finished_ts is not None \
            else self._clock()
        tel.histogram(_telemetry.SERVING_REQUEST_SECONDS,
                      "end-to-end request wall seconds"
                      ).observe(max(0.0, end - req.submitted))
        if req.admitted_ts is not None:
            tel.histogram(_telemetry.SERVING_PHASE_SECONDS,
                          "per-phase request latency",
                          phase="queue"
                          ).observe(max(0.0,
                                        req.admitted_ts - req.submitted))
        if req.first_token_ts is not None and req.admitted_ts is not None:
            tel.histogram(_telemetry.SERVING_PHASE_SECONDS,
                          "per-phase request latency",
                          phase="prefill"
                          ).observe(max(0.0, req.first_token_ts
                                        - req.admitted_ts))
            tel.histogram(_telemetry.SERVING_PHASE_SECONDS,
                          "per-phase request latency",
                          phase="decode"
                          ).observe(max(0.0, end - req.first_token_ts))

    def _admit(self, now: float) -> None:
        """Iteration-level admission: drop expired queue entries, then
        prefill queued requests into free slots. The static control arm
        only admits into an EMPTY batch (the barrier)."""
        if self.cfg.static_batching and self._active() > 0:
            return
        while True:
            free = [i for i, r in enumerate(self._slot_req) if r is None]
            if not free:
                return
            with self._lock:
                req = self._queue.popleft() if self._queue else None
                if req is not None:
                    self._queued -= 1
            if req is None:
                return
            if now > req.deadline:
                req.status = STATUS_DEADLINE
                req.finished_ts = now
                req.done.set()
                self._count_request(req, cause=EVICT_DEADLINE)
                continue
            slot = free[0]
            # prefill: write the prompt into the slot's buffer rows —
            # with the full-sequence forward there is no separate
            # prefill computation; the request's first iteration both
            # attends over the prompt and emits its first token, so the
            # prefill phase is admit -> first token by definition.
            self._tokens_host[slot, :] = 0
            self._tokens_host[slot, :len(req.prompt)] = req.prompt
            self._slot_pos[slot] = len(req.prompt) - 1
            req.admitted_ts = now
            self._slot_req[slot] = req

    def step(self) -> int:
        """One decode iteration: admission, one forward over the
        slot buffer, per-slot token append + mid-batch eviction.
        Returns the number of active slots decoded (0 = idle)."""
        params, fn, np_mod = self._ensure_model()
        now = self._clock()
        self._admit(now)
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        self._publish_gauges(len(active))
        if not active:
            return 0
        pos = np_mod.asarray(self._slot_pos, dtype=np_mod.int32)
        with runtime_metrics.device_busy():
            t0 = time.monotonic()
            next_ids = np_mod.asarray(fn(params, self._tokens_host, pos))
            self._duty.add_busy(time.monotonic() - t0)
        self.iterations += 1
        self.decoded_tokens += len(active)
        self._occupancy_samples.append(len(active))
        now = self._clock()
        tel = self.telemetry
        if tel is not None:
            tel.counter(_telemetry.SERVING_TOKENS_TOTAL,
                        "decoded tokens").inc(len(active))
        for slot in active:
            req = self._slot_req[slot]
            assert req is not None
            token = int(next_ids[slot])
            req.tokens.append(token)
            if req.first_token_ts is None:
                req.first_token_ts = now
            self._slot_pos[slot] += 1
            if self._tokens_host is not None \
                    and self._slot_pos[slot] < self.cfg.seq:
                self._tokens_host[slot, self._slot_pos[slot]] = token
            out_of_room = self._slot_pos[slot] >= self.cfg.seq - 1
            if len(req.tokens) >= req.max_new_tokens or out_of_room:
                self._finish(slot, STATUS_OK, now, EVICT_DONE)
            elif now > req.deadline:
                # mid-batch deadline eviction: the slot frees NOW, not
                # at a batch boundary
                self._finish(slot, STATUS_DEADLINE, now, EVICT_DEADLINE)
        if self.cfg.static_batching and self._active() > 0:
            # control arm: finished members already detached above, but
            # admission stays barred until the whole batch drains —
            # modeled by _admit's empty-batch gate, nothing to do here.
            pass
        return len(active)

    def _publish_gauges(self, occupied: int) -> None:
        tel = self.telemetry
        if tel is None:
            return
        with self._lock:
            depth = self._queued
        tel.gauge(_telemetry.SERVING_QUEUE_DEPTH,
                  "requests queued for a decode slot").set(float(depth))
        tel.gauge(_telemetry.SERVING_BATCH_SLOTS,
                  "configured decode batch slots"
                  ).set(float(self.cfg.slots))
        tel.gauge(_telemetry.SERVING_BATCH_OCCUPANCY,
                  "decode slots currently seated").set(float(occupied))
        duty = self._duty.percent()
        if duty is not None:
            tel.gauge(runtime_metrics.DUTY_CYCLE_PERCENT,
                      "fraction of wall-time with decode execution in "
                      "flight (trailing window; the autoscaler's scale "
                      "signal)").set(duty)

    def drain(self, timeout_s: float = 60.0) -> None:
        """Run iterations until queue and batch are empty (bench/tests;
        the deterministic alternative to the engine thread)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            decoded = self.step()
            if decoded == 0 and self.queue_depth() == 0 \
                    and self._active() == 0:
                return
        raise TimeoutError("serving drain did not converge")

    # ------------------------------------------------------------ thread

    def run(self, idle_wait_s: float = 0.05) -> None:
        """The engine loop (thread target): step continuously, parking
        on the queue condition when idle."""
        while not self._stop.is_set():
            decoded = self.step()
            if decoded == 0:
                with self._cv:
                    if not self._queue:
                        self._cv.wait(timeout=idle_wait_s)

    def start(self) -> "InferenceEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self.run, daemon=True,
                                            name="serving-engine")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def mean_occupancy(self) -> float:
        """Mean seated slots per decode iteration (the bench's batch-
        occupancy column; engine thread quiesced when read)."""
        if not self._occupancy_samples:
            return 0.0
        return sum(self._occupancy_samples) / len(self._occupancy_samples)


def bench_arm(static: bool, slots: int = 4, requests: int = 16,
              deadline_s: float = 120.0,
              device: burnin.DeviceLike = None) -> Dict[str, Any]:
    """One continuous-vs-static bench replay on ``device``: ``requests``
    requests with divergent decode lengths (2..20 tokens) fired as an
    open-loop burst against a fresh tiny engine — both arms see the
    identical arrival order, the only variable is the admission
    policy. Returns the loadgen report summary plus the engine's
    occupancy/iteration audit."""
    from . import loadgen

    cfg = ServingConfig(vocab=64, d_model=32, d_ff=64, n_heads=2,
                        seq=32, slots=slots, max_new_tokens=24,
                        default_deadline_s=deadline_s,
                        static_batching=static)
    eng = InferenceEngine(cfg, telemetry=_telemetry.Telemetry(),
                          device=device)
    eng.start()
    try:
        # warm-up request: pay the one-time model build outside the
        # timed replay
        warm = eng.submit((1, 2, 3), max_new_tokens=1)
        if not warm.done.wait(deadline_s):
            raise TimeoutError("serving warm-up never finished")
        gen = loadgen.LoadGenerator(
            [loadgen.engine_sender(eng)],
            steps=[loadgen.Step(qps=float(requests), duration_s=1.0)],
            prompt=(5, 6, 7, 8), deadline_s=deadline_s,
            tokens_for=lambda i: 2 + (i % 4) * 6,
            pace=False)
        report = gen.run()
    finally:
        eng.stop()
    out: Dict[str, Any] = report.summary()
    out["iterations"] = eng.iterations
    out["occupancy"] = round(eng.mean_occupancy(), 3)
    return out


# ---------------------------------------------------------------------------
# HTTP frontend.


class ServingServer:
    """The stdlib HTTP frontend + metrics endpoint for one engine.

    ``POST /v1/generate`` with ``{"prompt": [ints], "max_new_tokens":
    n, "deadline_s": s}`` blocks the handler thread on the request's
    completion event (the engine thread does all compute) and answers
    200/503/504 by terminal status; ``GET /healthz`` answers liveness.
    A ``metricsdb.MetricsServer`` on ``metrics_port`` serves the
    engine's registry to scrapers (the autoscaler's target)."""

    def __init__(self, engine: InferenceEngine, port: int = 0,
                 host: str = "127.0.0.1",
                 metrics_port: Optional[int] = 0) -> None:
        import json
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        self.engine = engine
        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args: Any) -> None:
                pass

            def _reply(self, code: int, doc: Dict[str, Any]) -> None:
                body = (json.dumps(doc, sort_keys=True) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                if self.path.partition("?")[0] == "/healthz":
                    self._reply(200, {"ok": True})
                else:
                    self._reply(404, {"error": "try /healthz"})

            def do_POST(self) -> None:
                if self.path.partition("?")[0] != "/v1/generate":
                    self._reply(404, {"error": "try /v1/generate"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    doc = json.loads(self.rfile.read(length) or b"{}")
                    prompt = tuple(int(t) for t in doc["prompt"])
                except (KeyError, TypeError, ValueError):
                    self._reply(400, {"error": "body must be JSON with "
                                               "a 'prompt' int array"})
                    return
                mnt = doc.get("max_new_tokens")
                ttl = doc.get("deadline_s")
                req = server_ref.engine.submit(
                    prompt,
                    max_new_tokens=int(mnt) if mnt is not None else None,
                    deadline_s=float(ttl) if ttl is not None else None)
                wait = (req.deadline - req.submitted) + 5.0
                req.done.wait(timeout=wait)
                status = req.status or STATUS_DEADLINE
                code = {STATUS_OK: 200, STATUS_DEADLINE: 504,
                        STATUS_REJECTED: 503}.get(status, 500)
                end = req.finished_ts if req.finished_ts is not None \
                    else req.deadline
                self._reply(code, {
                    "status": status, "tokens": list(req.tokens),
                    "latency_s": round(max(0.0, end - req.submitted), 6),
                })

        self._http = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True,
            name=f"serving-http-{self.port}")
        self.metrics: Optional[Any] = None
        if metrics_port is not None and engine.telemetry is not None:
            from .. import metricsdb

            self.metrics = metricsdb.MetricsServer(
                engine.telemetry.metrics, metrics_port, host=host)

    @property
    def port(self) -> int:
        return int(self._http.server_address[1])

    @property
    def url(self) -> str:
        host = str(self._http.server_address[0])
        return f"http://{host}:{self.port}"

    @property
    def metrics_url(self) -> str:
        return str(self.metrics.url) if self.metrics is not None else ""

    def start(self) -> "ServingServer":
        self.engine.start()
        self._http_thread.start()
        if self.metrics is not None:
            self.metrics.start()
        return self

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        if self.metrics is not None:
            self.metrics.stop()
        self.engine.stop()

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()
