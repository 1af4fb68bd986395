"""Metrics-driven autoscaler for the serving operand. The port's own
copy of ``tpu_cluster/autoscale.py``.

The HPA analog, specialised for gang-scheduled GPU serving: scrape the
serving replicas' metrics endpoints through ``metricsdb.ScrapeManager``,
window ``tpu_duty_cycle_percent`` and queue depth into a load view,
and converge the number of gang-annotated serving Jobs toward the
desired replica count — THROUGH the admission path, never around it.

Why not just HPA semantics on parallelism? A serving replica is a
GANG: all-or-nothing seats on whole hosts. Patching a Job's parallelism
up by one would strand a partial gang (the anti-pattern the admission
loop exists to prevent), so:

- **scale-out** applies a NEW gang-annotated Job (``<job>-<i>``, gang
  ``<job>/<i>``, one host) and lets the admission controller arbitrate
  the whole gang against live capacity;
- **scale-in** DELETES the highest-index replica Job whole — the
  drain-whole discipline; the admission loop's preemption/readmission
  machinery observes the vacated seats;
- a further scale-out is BLOCKED while any existing replica gang is
  still queued (arbitration pending) — the controller never piles
  intents on top of an unadmitted gang.

Decision discipline: **hysteresis** — scale out at ``duty_high`` /
queue pressure, back in only below ``duty_low`` with an idle queue,
nothing in the band between; **cooldown** — a wall clock lockout after
every scale so a flapping metric cannot saw the fleet; **fail-open** —
when every scrape target is down (`up` == 0) the metrics are absent,
not zero, and the controller HOLDS replicas rather than scaling in on
blindness.

Crash-restartable exactly like maintenance.py: desired replicas +
cooldown persist in the :data:`AUTOSCALE_CONFIGMAP` ConfigMap (canonical
JSON, schema-versioned, fail-closed parse), Job convergence is
level-triggered from persisted state every pass, scale Events drain
only after the state publish lands (the persisted count is the
exactly-once memo), and ``autoscale run --once`` gives cron-style
single passes that resume mid-decision.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from . import admission
from . import kubeapply
from . import metricsdb
from . import telemetry as _telemetry
from .workloads import runtime_metrics

# Persistent-state coordinates (admission's recovery shape, applied to
# autoscaling). The document key differs from maintenance's on purpose:
# the two controllers' states are different contracts. The ConfigMap's
# name is the GPU stack's own.
AUTOSCALE_CONFIGMAP = "gpu-autoscale-state"
AUTOSCALE_KEY = "autoscale.json"
AUTOSCALE_SCHEMA_VERSION = 1

# Marks a Job as one replica of a serving deployment; the value is the
# deployment's base job name (the autoscaler's ownership filter — it
# only ever touches Jobs it stamped).
SERVING_REPLICA_ANNOTATION = "tpu-stack.dev/serving-replica"

# Scale-transition Event reasons, posted on the state ConfigMap.
EVENT_SCALED_UP = "ScaledUp"
EVENT_SCALED_DOWN = "ScaledDown"
EVENT_SCALE_BLOCKED = "ScaleBlocked"

# Decision verdicts (the tpu_autoscale_decisions_total label values).
VERDICT_UP = "up"
VERDICT_DOWN = "down"
VERDICT_HOLD = "hold"
VERDICT_BLOCKED = "blocked"


@dataclass(frozen=True)
class AutoscalePolicy:
    """The scaling law. ``duty_high``/``duty_low`` bound the hysteresis
    band on windowed ``tpu_duty_cycle_percent``; ``queue_high`` is
    queued requests per replica (either signal scales out — queue
    pressure catches saturation before duty saturates at 100)."""

    min_replicas: int = 1
    max_replicas: int = 4
    duty_high: float = 75.0
    duty_low: float = 25.0
    queue_high: float = 4.0
    window_s: float = 30.0
    cooldown_s: float = 60.0

    def validate(self) -> None:
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if not (0.0 <= self.duty_low < self.duty_high):
            raise ValueError("need 0 <= duty_low < duty_high")


@dataclass(frozen=True)
class MetricsView:
    """One pass's windowed load observation across the replica fleet."""

    targets_total: int = 0
    targets_up: int = 0
    duty_percent: Optional[float] = None   # mean over up replicas
    queue_depth: Optional[float] = None    # summed over replicas

    def line(self) -> str:
        duty = "-" if self.duty_percent is None \
            else f"{self.duty_percent:.0f}%"
        queue = "-" if self.queue_depth is None \
            else f"{self.queue_depth:g}"
        return (f"up {self.targets_up}/{self.targets_total}, "
                f"duty {duty}, queue {queue}")


def observe(tsdb: metricsdb.TSDB, window_s: float,
            now: Optional[float] = None) -> MetricsView:
    """Windowed load view from scraped series: duty is the mean of each
    replica's window-averaged duty gauge, queue depth the sum of latest
    per-replica gauges. Missing series stay ``None`` (absent ≠ zero —
    the fail-open distinction)."""
    up = tsdb.latest(_telemetry.UP, now=now)
    duties: List[float] = []
    for _labels, samples in tsdb.window(
            runtime_metrics.DUTY_CYCLE_PERCENT, window_s, now=now).items():
        if samples:
            duties.append(sum(v for _t, v in samples) / len(samples))
    queues = tsdb.latest(_telemetry.SERVING_QUEUE_DEPTH, now=now)
    return MetricsView(
        targets_total=len(up),
        targets_up=sum(1 for v in up.values() if v > 0),
        duty_percent=(sum(duties) / len(duties)) if duties else None,
        queue_depth=sum(queues.values()) if queues else None)


@dataclass(frozen=True)
class ScaleDecision:
    verdict: str
    desired: int
    reason: str


def decide(view: MetricsView, replicas: int, policy: AutoscalePolicy,
           now_wall: float, cooldown_until: float) -> ScaleDecision:
    """The pure scaling decision (what the tests pin): hysteresis band,
    cooldown lockout, fail-open on scrape blindness."""
    if view.targets_total > 0 and view.targets_up == 0:
        return ScaleDecision(VERDICT_HOLD, replicas,
                             "fail-open: all scrape targets down")
    duty = view.duty_percent if view.duty_percent is not None else 0.0
    queue = view.queue_depth if view.queue_depth is not None else 0.0
    per_replica = queue / max(1, replicas)
    overloaded = duty >= policy.duty_high \
        or per_replica >= policy.queue_high
    # scale-in demands EVIDENCE of idleness, not absence of evidence:
    # a replica whose duty series never arrived (down exporter, fresh
    # TSDB) reads as None, and None is blindness — hold, don't shrink.
    underloaded = view.duty_percent is not None \
        and duty <= policy.duty_low and per_replica < 1.0
    if overloaded:
        why = (f"duty {duty:.0f}% >= {policy.duty_high:g}%"
               if duty >= policy.duty_high else
               f"queue/replica {per_replica:g} >= {policy.queue_high:g}")
        if replicas >= policy.max_replicas:
            return ScaleDecision(
                VERDICT_BLOCKED, replicas,
                f"{why} but at max_replicas {policy.max_replicas}")
        if now_wall < cooldown_until:
            return ScaleDecision(
                VERDICT_HOLD, replicas,
                f"{why} but in cooldown "
                f"({cooldown_until - now_wall:.0f}s left)")
        return ScaleDecision(VERDICT_UP, replicas + 1, why)
    if underloaded and replicas > policy.min_replicas:
        why = (f"duty {duty:.0f}% <= {policy.duty_low:g}% "
               f"and queue idle")
        if now_wall < cooldown_until:
            return ScaleDecision(
                VERDICT_HOLD, replicas,
                f"{why} but in cooldown "
                f"({cooldown_until - now_wall:.0f}s left)")
        return ScaleDecision(VERDICT_DOWN, replicas - 1, why)
    return ScaleDecision(VERDICT_HOLD, replicas,
                         "within hysteresis band")


# ---------------------------------------------------------------------------
# Persistent state.


@dataclass
class ScaleState:
    """What survives a controller crash: the deployment identity, the
    desired replica count, and the cooldown lockout (WALL clock — a
    fresh process must keep honouring its predecessor's cooldown)."""

    job: str
    accelerator: str
    replicas: int
    cooldown_until: float = 0.0
    last_blocked: str = ""


def build_state(state: ScaleState) -> Dict[str, Any]:
    return {
        "version": AUTOSCALE_SCHEMA_VERSION,
        "job": state.job,
        "accelerator": state.accelerator,
        "replicas": state.replicas,
        "cooldown_until": state.cooldown_until,
        "last_blocked": state.last_blocked,
    }


def parse_state(doc: Mapping[str, Any]) -> ScaleState:
    """Fail-closed parse: wrong schema version or malformed fields
    raise (the caller starts fresh and republishes canonically)."""
    if not isinstance(doc, Mapping):
        raise ValueError("autoscale state must be a JSON object")
    if doc.get("version") != AUTOSCALE_SCHEMA_VERSION:
        raise ValueError(
            f"autoscale state schema {doc.get('version')!r} != "
            f"{AUTOSCALE_SCHEMA_VERSION}")
    job = str(doc.get("job") or "")
    acc = str(doc.get("accelerator") or "")
    if not job or not acc:
        raise ValueError("autoscale state missing job/accelerator")
    try:
        replicas = int(doc["replicas"])
        cooldown = float(doc.get("cooldown_until", 0.0))
    except (KeyError, TypeError, ValueError) as err:
        raise ValueError(f"autoscale state malformed: {err}") from None
    if replicas < 0:
        raise ValueError("autoscale state replicas < 0")
    return ScaleState(job=job, accelerator=acc, replicas=replicas,
                      cooldown_until=cooldown,
                      last_blocked=str(doc.get("last_blocked") or ""))


def replica_job_name(job: str, index: int) -> str:
    return f"{job}-{index}"


def replica_manifest(job: str, index: int, accelerator: str,
                     namespace: str) -> Dict[str, Any]:
    """One serving replica: a gang-annotated Indexed Job of one host
    (gang ``<job>/<i>``) stamped with the replica annotation so the
    autoscaler can find its own children."""
    manifest = admission.gang_job_manifest(
        f"{job}/{index}", accelerator, namespace,
        job_name=replica_job_name(job, index), hosts=1)
    anns = manifest["metadata"]["annotations"]
    anns[SERVING_REPLICA_ANNOTATION] = job
    return manifest


def replica_index(job: str, name: str) -> Optional[int]:
    prefix = f"{job}-"
    if not name.startswith(prefix):
        return None
    try:
        return int(name[len(prefix):])
    except ValueError:
        return None


@dataclass
class AutoscaleResult:
    """One pass's outcome (the ``autoscale`` status line)."""

    verdict: str = VERDICT_HOLD
    reason: str = ""
    replicas: int = 0
    view: Optional[MetricsView] = None
    applied: List[str] = field(default_factory=list)
    deleted: List[str] = field(default_factory=list)
    published: bool = False
    events: int = 0
    # overload-observed -> scale-out-decided wall seconds, on the pass
    # that decided the scale-out (None otherwise) — the reaction time
    reaction_s: Optional[float] = None

    def line(self) -> str:
        bits = [f"replicas {self.replicas}",
                f"decision {self.verdict}" +
                (f" ({self.reason})" if self.reason else "")]
        if self.view is not None:
            bits.append(self.view.line())
        if self.applied:
            bits.append("applied " + ", ".join(self.applied))
        if self.deleted:
            bits.append("deleted " + ", ".join(self.deleted))
        if self.published:
            bits.append("state published")
        return "autoscale: " + "; ".join(bits)


class AutoscaleController:
    """The metrics→replicas control loop against one apiserver.

    ``step()`` is one pass: scrape the replica targets, LIST the
    replica Jobs, decide under the lock (pure), then apply/delete Jobs,
    publish state, and emit Events OUTSIDE it. ``run()`` loops it;
    ``autoscale run --once`` does scrape passes + one step in a fresh
    process."""

    def __init__(self, client: kubeapply.Client, namespace: str,
                 job: str = "serving",
                 accelerator: str = "h100-sxm5-80gb-8",
                 policy: AutoscalePolicy = AutoscalePolicy(),
                 targets: Sequence[metricsdb.Target] = (),
                 tsdb: Optional[metricsdb.TSDB] = None,
                 telemetry: Optional[_telemetry.Telemetry] = None,
                 events: Optional[Any] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time) -> None:
        policy.validate()
        self.client = client
        self.namespace = namespace
        self.job = job
        self.accelerator = accelerator
        self.policy = policy
        self.telemetry = telemetry
        self.events = events
        self.tsdb = tsdb if tsdb is not None else metricsdb.TSDB()
        self.scrape: Optional[metricsdb.ScrapeManager] = None
        if targets:
            self.scrape = metricsdb.ScrapeManager(
                targets, self.tsdb, telemetry=telemetry)
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._state: Optional[ScaleState] = None  # guarded-by: _lock
        self._last_published: Optional[str] = None  # guarded-by: _lock
        self._bootstrapped = False  # guarded-by: _lock
        # scale events awaiting emission: queued by _reconcile, drained
        # AFTER the state publish lands — the persisted replica count
        # is the exactly-once memo (a pass that dies pre-publish
        # re-derives the transition; a fresh process that reads the
        # published count does NOT re-emit it).
        self._pending_events: List[Tuple[str, str, str]] = []  # guarded-by: _lock
        # first instant the current overload episode was observed
        # (monotonic; feeds the scale-out reaction histogram) — in
        # memory only, a restart forfeits the sample, never the scale.
        self._overload_since: Optional[float] = None  # guarded-by: _lock
        self.last_reaction_s: Optional[float] = None  # guarded-by: _lock
        self.passes = 0  # guarded-by: _lock

    # ------------------------------------------------------------- state

    def state_snapshot(self) -> Optional[ScaleState]:
        with self._lock:
            if self._state is None:
                return None
            return parse_state(build_state(self._state))

    def _state_path(self) -> str:
        return (f"/api/v1/namespaces/{self.namespace}/configmaps/"
                f"{AUTOSCALE_CONFIGMAP}")

    def _state_ref(self) -> Dict[str, str]:
        return {"apiVersion": "v1", "kind": "ConfigMap",
                "namespace": self.namespace,
                "name": AUTOSCALE_CONFIGMAP}

    def _jobs_path(self) -> str:
        return f"/apis/batch/v1/namespaces/{self.namespace}/jobs"

    def _publish(self, payload: str) -> None:
        self.client.apply({
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {
                "name": AUTOSCALE_CONFIGMAP,
                "namespace": self.namespace,
                "labels": {"app.kubernetes.io/part-of": admission.PART_OF},
            },
            "data": {AUTOSCALE_KEY: payload},
        })

    def _maybe_bootstrap(self) -> None:
        """Recover the predecessor's desired count + cooldown from the
        state ConfigMap. A published state for the SAME deployment wins
        over constructor defaults (the fresh process must not re-decide
        — that is what makes `--once` passes resumable with no
        duplicate scale Events); a different deployment or an
        unparseable document starts fresh at min_replicas and forces a
        canonical republish."""
        with self._lock:
            if self._bootstrapped:
                return
        code, cm = self.client.get(self._state_path())
        recovered: Optional[ScaleState] = None
        last: Optional[str] = None
        if code == 200:
            raw = str((cm.get("data") or {}).get(AUTOSCALE_KEY) or "")
            last = raw
            if raw:
                try:
                    parsed = parse_state(json.loads(raw))
                except (ValueError, TypeError):
                    parsed = None
                if parsed is not None and parsed.job == self.job \
                        and parsed.accelerator == self.accelerator:
                    recovered = parsed
        state = recovered if recovered is not None else ScaleState(
            job=self.job, accelerator=self.accelerator,
            replicas=self.policy.min_replicas)
        with self._lock:
            if self._bootstrapped:
                return
            self._bootstrapped = True
            self._state = state
            self._last_published = last

    # ------------------------------------------------------------- pass

    def step(self) -> AutoscaleResult:
        """One autoscale pass (also the ``autoscale-pass`` span)."""
        tel = self.telemetry
        with _telemetry.maybe_span(tel, "autoscale-pass", "autoscale"):
            self._maybe_bootstrap()
            if self.scrape is not None:
                self.scrape.scrape_once()
            jobs = self.client.list_collection(self._jobs_path())
            observed: Dict[int, Mapping[str, Any]] = {}
            for name, obj in jobs.items():
                anns = (obj.get("metadata") or {}).get("annotations") or {}
                if anns.get(SERVING_REPLICA_ANNOTATION) != self.job:
                    continue
                idx = replica_index(self.job, name)
                if idx is not None:
                    observed[idx] = obj
            view = observe(self.tsdb, self.policy.window_s,
                           now=self._clock())
            now_mono = self._clock()
            now_wall = self._wall()
            with self._lock:
                applies, deletes, publish, result = self._reconcile(
                    view, observed, now_mono, now_wall)
            for manifest in applies:
                self.client.apply(manifest)
            for path in deletes:
                self.client.delete(path)
            if publish is not None:
                self._publish(publish)
                with self._lock:
                    self._last_published = publish
                result.published = True
            with self._lock:
                emit = list(self._pending_events)
                self._pending_events = []
                reaction = self.last_reaction_s
                self.last_reaction_s = None
                self.passes += 1
            result.reaction_s = reaction
            rec = self.events
            if rec is not None:
                involved = self._state_ref()
                for reason, message, type_ in emit:
                    rec.emit(involved, reason, message, type_=type_)
            result.events = len(emit)
            if tel is not None:
                tel.gauge(_telemetry.AUTOSCALE_REPLICAS,
                          "desired serving replicas"
                          ).set(float(result.replicas))
                tel.counter(_telemetry.AUTOSCALE_DECISIONS_TOTAL,
                            "autoscale decisions by verdict",
                            verdict=result.verdict).inc()
                if reaction is not None:
                    tel.histogram(
                        _telemetry.AUTOSCALE_REACTION_SECONDS,
                        "overload observed -> scale-out decided wall "
                        "seconds").observe(reaction)
            return result

    # requires: self._lock
    def _reconcile(self, view: MetricsView,
                   observed: Mapping[int, Mapping[str, Any]],
                   now_mono: float, now_wall: float
                   ) -> Tuple[List[Dict[str, Any]], List[str],
                              Optional[str], AutoscaleResult]:
        """The pure pass body (requires: _lock). Decides, mutates
        persisted state, queues events, and derives the level-triggered
        Job convergence — all apiserver I/O stays with the caller."""
        state = self._state
        assert state is not None
        policy = self.policy
        result = AutoscaleResult(view=view)

        decision = decide(view, state.replicas, policy, now_wall,
                          state.cooldown_until)
        # gang-arbitration gate: never stack a new gang on top of an
        # unadmitted one — the seats a queued (or not-yet-created) gang
        # will take are not knowable yet, so a further scale-out is
        # premature; converge what is owed first, scale next pass.
        if decision.verdict == VERDICT_UP:
            pending = sorted(
                idx for idx in range(state.replicas)
                if idx not in observed
                or ((observed[idx].get("metadata") or {})
                    .get("annotations") or {}
                    ).get(admission.GANG_STATUS_ANNOTATION)
                == admission.STATUS_QUEUED)
            if pending:
                decision = ScaleDecision(
                    VERDICT_BLOCKED, state.replicas,
                    f"replica {replica_job_name(state.job, pending[0])} "
                    "awaiting gang arbitration")

        # overload episode tracking for the reaction histogram
        duty = view.duty_percent if view.duty_percent is not None else 0.0
        queue = view.queue_depth if view.queue_depth is not None else 0.0
        overloaded = duty >= policy.duty_high or \
            queue / max(1, state.replicas) >= policy.queue_high
        if overloaded and view.targets_up > 0:
            if self._overload_since is None:
                self._overload_since = now_mono
        elif not overloaded:
            self._overload_since = None

        before = state.replicas
        if decision.verdict == VERDICT_UP:
            state.replicas = decision.desired
            state.cooldown_until = now_wall + policy.cooldown_s
            self._pending_events.append((
                EVENT_SCALED_UP,
                f"{state.job}: {before} -> {state.replicas} replica(s) "
                f"({decision.reason})", "Normal"))
            if self._overload_since is not None:
                self.last_reaction_s = max(
                    0.0, now_mono - self._overload_since)
                self._overload_since = None
        elif decision.verdict == VERDICT_DOWN:
            state.replicas = decision.desired
            state.cooldown_until = now_wall + policy.cooldown_s
            self._pending_events.append((
                EVENT_SCALED_DOWN,
                f"{state.job}: {before} -> {state.replicas} replica(s) "
                f"({decision.reason})", "Normal"))
        if decision.verdict == VERDICT_BLOCKED:
            # edge-triggered Warning: once per distinct blockage, not
            # once per pass (a held-at-max fleet would otherwise spam)
            if state.last_blocked != decision.reason:
                state.last_blocked = decision.reason
                self._pending_events.append((
                    EVENT_SCALE_BLOCKED,
                    f"{state.job}: {decision.reason}", "Warning"))
        else:
            state.last_blocked = ""

        # level-triggered convergence to the persisted desired count:
        # missing low indices re-applied (lost writes heal), indices at
        # or past desired deleted whole (drain-whole scale-in) — runs
        # even on hold/fail-open passes.
        applies: List[Dict[str, Any]] = []
        deletes: List[str] = []
        for idx in range(state.replicas):
            if idx not in observed:
                applies.append(replica_manifest(
                    state.job, idx, state.accelerator, self.namespace))
                result.applied.append(replica_job_name(state.job, idx))
        for idx in sorted(observed):
            if idx >= state.replicas:
                deletes.append(
                    f"{self._jobs_path()}/"
                    f"{replica_job_name(state.job, idx)}")
                result.deleted.append(replica_job_name(state.job, idx))

        payload = json.dumps(build_state(state), sort_keys=True,
                             separators=(",", ":"))
        publish = payload if payload != self._last_published else None
        result.verdict = decision.verdict
        result.reason = decision.reason
        result.replicas = state.replicas
        return applies, deletes, publish, result

    # ------------------------------------------------------------- loop

    def run(self, interval: float = 1.0,
            stop: Optional[threading.Event] = None,
            max_passes: int = 0) -> None:
        """Poll-loop the controller (``autoscale run``): one
        pass per interval until ``stop`` or ``max_passes``; apiserver
        flakes are absorbed (next pass retries — every pass is a full
        level-triggered reconcile)."""
        done = 0
        while stop is None or not stop.is_set():
            try:
                self.step()
            except kubeapply.ApplyError:
                pass
            done += 1
            if max_passes and done >= max_passes:
                return
            if stop is not None:
                if stop.wait(timeout=interval):
                    return
            else:
                time.sleep(interval)


def fetch_state(client: kubeapply.Client,
                namespace: str) -> Optional[ScaleState]:
    """The published autoscale state, or None when absent/unparseable
    (the next controller pass repairs it)."""
    code, cm = client.get(
        f"/api/v1/namespaces/{namespace}/configmaps/"
        f"{AUTOSCALE_CONFIGMAP}")
    if code != 200:
        return None
    raw = str((cm.get("data") or {}).get(AUTOSCALE_KEY) or "")
    if not raw:
        return None
    try:
        return parse_state(json.loads(raw))
    except (ValueError, TypeError):
        return None


def format_status(state: Optional[ScaleState]) -> str:
    """The ``autoscale status`` rendering."""
    if state is None:
        return "autoscale: no published state"
    return (f"autoscale: job {state.job} ({state.accelerator}), "
            f"{state.replicas} replica(s), cooldown_until "
            f"{state.cooldown_until:.0f}"
            + (f", blocked: {state.last_blocked}"
               if state.last_blocked else ""))
