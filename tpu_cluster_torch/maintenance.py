"""Rolling maintenance orchestration: cordon/drain/upgrade waves with
gang disruption budgets. The port's own copy of
``tpu_cluster/maintenance.py``.

The one operation every production fleet runs weekly -- a rolling
device-plugin/driver upgrade -- is where gang admission either proves
itself or deadlocks a workload: a partial drain is not degraded
capacity, it is a stranded multi-host gang holding cards it can never
use. This module is the Kueue/node-maintenance-operator shape applied
to whole-host GPU gangs:

- **Wave plan.** A declarative :class:`WavePlan`: ordered host groups
  ("g/0".."g/N", never mixing host layouts) plus a target stack
  version and a :class:`GangDisruptionBudget` (a PDB analog at gang
  granularity: max concurrently-drained gangs per host layout, min
  host groups left schedulable).
- **Cordon.** Starting a group PATCHes each Node with
  ``spec.unschedulable: true`` and the
  :data:`admission.MAINTENANCE_ANNOTATION` naming the group. The
  admission loop stops seating gangs there (stickiness breaks, so
  resident gangs drain WHOLE through its drain path) and the published
  reservation table's ``cordoned`` list makes
  :func:`admission.check_allocation` refuse seats during the drain race
  window.
- **Drain is observed, not performed.** The AdmissionController owns
  draining; this controller watches the reservation table until no
  resident gang holds a group's hosts.
- **Upgrade + health gate.** The simulated upgrade rewrites the
  :data:`VERSION_LABEL` on each node; the uncordon is gated on the
  node observing Ready AND the label matching the target.
- **Crash-restartable.** Wave state persists in a ConfigMap
  (:data:`MAINTENANCE_CONFIGMAP`) with admission's ``_maybe_bootstrap``
  recovery shape: a SIGKILL'd controller resumes mid-wave without
  re-draining finished groups; an unparseable document recovers from
  the plan and forces a canonical re-publish. Because every desired
  state (cordon, label, uncordon) is recomputed from the persisted
  phase each pass, a write lost to a crash or a chaos flap is simply
  re-issued -- level-triggered.
- **Observable.** Every phase transition emits a Kubernetes Event
  (CordonStarted/GangDrained/UpgradeApplied/Uncordoned/WaveComplete)
  on the state ConfigMap and the ``tpu_maintenance_*`` metric
  families on the shared registry.

Concurrency: one ``_lock`` guards controller state; all apiserver I/O
happens OUTSIDE it, so the maintenance lock is a leaf in the
process-wide acquisition graph.
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

from . import admission, kubeapply, telemetry as _telemetry

# The persisted wave-state contract (the reservation-ConfigMap shape,
# applied to maintenance). The ConfigMap's name is the GPU stack's own.
MAINTENANCE_CONFIGMAP = "gpu-maintenance-state"
MAINTENANCE_KEY = "state.json"
MAINTENANCE_SCHEMA_VERSION = 1

# The node label the simulated device-plugin/driver upgrade rewrites
# (the reference's name, which the fake apiserver's kubelet hook also
# writes); the health gate requires it to match the wave target before
# uncordoning.
VERSION_LABEL = "tpu-stack.dev/stack-version"

# Wave-group phases, in lifecycle order. pending -> cordoned is the
# budget-gated decision; every later transition is OBSERVED from
# cluster state, so a restarted controller converges from wherever its
# predecessor left the world.
PHASE_PENDING = "pending"
PHASE_CORDONED = "cordoned"
PHASE_DRAINED = "drained"
PHASE_UPGRADED = "upgraded"
PHASE_DONE = "done"
PHASES = (PHASE_PENDING, PHASE_CORDONED, PHASE_DRAINED, PHASE_UPGRADED,
          PHASE_DONE)
# phases counted as "disrupting" for the budget / availability gates
_ACTIVE_PHASES = (PHASE_CORDONED, PHASE_DRAINED, PHASE_UPGRADED)

# Event reasons — one per phase transition, posted on the state
# ConfigMap (the wave's own object; per-gang Drained/ReAdmitted events
# stay on the gang Jobs, emitted by the admission loop).
EVENT_CORDON_STARTED = "CordonStarted"
EVENT_GANG_DRAINED = "GangDrained"
EVENT_UPGRADE_APPLIED = "UpgradeApplied"
EVENT_UNCORDONED = "Uncordoned"
EVENT_WAVE_COMPLETE = "WaveComplete"


# --------------------------------------------------------------------------
# The declarative plan.


@dataclass(frozen=True)
class GangDisruptionBudget:
    """A PodDisruptionBudget analog at gang granularity: how much of the
    fleet a wave may disrupt at once. ``max_drained_gangs`` bounds
    concurrently-drained gangs PER ACCELERATOR TYPE (a group's own
    resident gangs are always allowed — a host cannot be upgraded
    without draining what sits on it — but a new group never starts
    while it would push the total past the budget).
    ``min_available_groups`` is the floor of host groups left fully
    schedulable while a wave runs."""

    max_drained_gangs: int = 1
    min_available_groups: int = 0


@dataclass(frozen=True)
class HostGroup:
    """One wave group: the hosts cordoned/upgraded/uncordoned as a
    unit."""

    name: str
    hosts: Tuple[str, ...]


@dataclass(frozen=True)
class WavePlan:
    """The declarative rolling-upgrade input: ordered host groups and
    the stack version they converge to."""

    target_version: str
    groups: Tuple[HostGroup, ...]
    budget: GangDisruptionBudget = GangDisruptionBudget()


def _group_key(name: str) -> Tuple[int, str]:
    """Wave order: numeric suffix first ("g/2" before "g/10"), then
    lexicographic for names without one."""
    m = re.search(r"(\d+)$", name)
    return (int(m.group(1)) if m else (1 << 30), name)


def plan_waves(hosts: Sequence[admission.HostCapacity],
               target_version: str, group_size: int = 1,
               budget: Optional[GangDisruptionBudget] = None) -> WavePlan:
    """Partition a GPU fleet into wave groups: hosts grouped by host
    layout (a group never mixes layouts — the budget is per layout), chunked ``group_size`` at a time in sorted host order,
    named ``g/0``..``g/N`` in upgrade order."""
    if group_size < 1:
        raise ValueError("group_size must be >= 1")
    by_acc: Dict[str, List[str]] = {}
    for h in hosts:
        by_acc.setdefault(h.accelerator, []).append(h.name)
    groups: List[HostGroup] = []
    idx = 0
    for acc in sorted(by_acc):
        names = sorted(by_acc[acc])
        for i in range(0, len(names), group_size):
            groups.append(HostGroup(name=f"g/{idx}",
                                    hosts=tuple(names[i:i + group_size])))
            idx += 1
    return WavePlan(target_version=target_version, groups=tuple(groups),
                    budget=budget or GangDisruptionBudget())


def plan_from_cluster(client: kubeapply.Client, target_version: str,
                      group_size: int = 1,
                      budget: Optional[GangDisruptionBudget] = None
                      ) -> WavePlan:
    """`maintain plan`: build a wave plan from the live fleet (every
    node advertising a GPU product)."""
    nodes = client.list_collection(admission.NODES_PATH)
    hosts = [h for h in (admission.host_capacity(n)
                         for n in nodes.values()) if h is not None]
    return plan_waves(hosts, target_version, group_size=group_size,
                      budget=budget)


def format_plan(plan: WavePlan) -> str:
    """The `maintain plan` rendering."""
    lines = [f"target version: {plan.target_version}",
             f"budget: max {plan.budget.max_drained_gangs} drained "
             "gang(s) per accelerator type, min "
             f"{plan.budget.min_available_groups} available group(s)",
             f"{len(plan.groups)} wave group(s):"]
    for g in plan.groups:
        shown = ", ".join(g.hosts[:6]) + (" ..." if len(g.hosts) > 6
                                          else "")
        lines.append(f"  {g.name}: {len(g.hosts)} host(s) — {shown}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# Persisted wave state — (de)serialised with the reservation-table
# discipline: canonical form, fail-closed parse, additive-only schema.


@dataclass
class GroupState:
    """One wave group's persisted progress."""

    hosts: Tuple[str, ...]
    phase: str = PHASE_PENDING
    # gangs this group's cordon drained (gang -> accelerator type),
    # kept until the gang re-admits elsewhere or its Job disappears —
    # the budget's unit of account across groups AND restarts
    draining: Dict[str, str] = field(default_factory=dict)


@dataclass
class WaveState:
    """The whole persisted wave: what `state.json` round-trips."""

    target: str
    budget: GangDisruptionBudget
    groups: Dict[str, GroupState]
    complete: bool = False


def state_from_plan(plan: WavePlan) -> WaveState:
    return WaveState(
        target=plan.target_version, budget=plan.budget,
        groups={g.name: GroupState(hosts=tuple(sorted(g.hosts)))
                for g in plan.groups})


def build_state(state: WaveState) -> Dict[str, Any]:
    """The ``state.json`` document — canonical (sorted) so equal states
    render byte-identical and the publish path can diff cheaply."""
    groups: Dict[str, Any] = {}
    for name in sorted(state.groups, key=_group_key):
        gs = state.groups[name]
        entry: Dict[str, Any] = {"hosts": sorted(gs.hosts),
                                 "phase": gs.phase}
        if gs.draining:
            entry["draining"] = {g: gs.draining[g]
                                 for g in sorted(gs.draining)}
        groups[name] = entry
    return {
        "version": MAINTENANCE_SCHEMA_VERSION,
        "target": state.target,
        "budget": {
            "max_drained_gangs": state.budget.max_drained_gangs,
            "min_available_groups": state.budget.min_available_groups,
        },
        "groups": groups,
        "complete": state.complete,
    }


def parse_state(doc: Mapping[str, Any]) -> WaveState:
    """Parse a persisted wave document; raises ``ValueError`` on a
    wrong schema version or malformed entries (fails closed as a unit,
    like the reservation table)."""
    version = doc.get("version")
    if version != MAINTENANCE_SCHEMA_VERSION:
        raise ValueError(
            f"maintenance: unsupported schema version {version!r} "
            f"(want {MAINTENANCE_SCHEMA_VERSION})")
    budget_in = doc.get("budget") or {}
    if not isinstance(budget_in, Mapping):
        raise ValueError("maintenance: 'budget' is not an object")
    budget = GangDisruptionBudget(
        max_drained_gangs=int(budget_in.get("max_drained_gangs", 1)),
        min_available_groups=int(budget_in.get("min_available_groups", 0)))
    groups_in = doc.get("groups") or {}
    if not isinstance(groups_in, Mapping):
        raise ValueError("maintenance: 'groups' is not an object")
    groups: Dict[str, GroupState] = {}
    for name, entry in groups_in.items():
        if not isinstance(entry, Mapping):
            raise ValueError(
                f"maintenance: group {name!r} is not an object")
        hosts_in = entry.get("hosts")
        if (not isinstance(hosts_in, Sequence)
                or isinstance(hosts_in, str)
                or not all(isinstance(h, str) for h in hosts_in)):
            raise ValueError(
                f"maintenance: group {name!r} 'hosts' is not a string "
                "array")
        phase = str(entry.get("phase", PHASE_PENDING))
        if phase not in PHASES:
            raise ValueError(
                f"maintenance: group {name!r} has unknown phase "
                f"{phase!r}")
        draining_in = entry.get("draining") or {}
        if not isinstance(draining_in, Mapping):
            raise ValueError(
                f"maintenance: group {name!r} 'draining' is not an "
                "object")
        groups[str(name)] = GroupState(
            hosts=tuple(sorted(str(h) for h in hosts_in)), phase=phase,
            draining={str(g): str(a) for g, a in draining_in.items()})
    return WaveState(target=str(doc.get("target", "")), budget=budget,
                     groups=groups, complete=bool(doc.get("complete")))


# --------------------------------------------------------------------------
# Observed node state.


@dataclass(frozen=True)
class NodeView:
    """One Node's maintenance-relevant observed state."""

    name: str
    ready: bool
    cordoned: bool
    note: str      # MAINTENANCE_ANNOTATION value ("" when absent)
    version: str   # VERSION_LABEL value ("" when absent)


def node_view(node: Mapping[str, Any]) -> Optional[NodeView]:
    meta = node.get("metadata") or {}
    name = str(meta.get("name") or "")
    if not name:
        return None
    labels = meta.get("labels") or {}
    anns = meta.get("annotations") or {}
    spec = node.get("spec") or {}
    status = node.get("status") or {}
    ready = False
    for cond in status.get("conditions") or []:
        if isinstance(cond, Mapping) and cond.get("type") == "Ready":
            ready = str(cond.get("status")) == "True"
    note = str(anns.get(admission.MAINTENANCE_ANNOTATION) or "")
    return NodeView(
        name=name, ready=ready,
        cordoned=bool(spec.get("unschedulable")) or bool(note),
        note=note, version=str(labels.get(VERSION_LABEL) or ""))


# --------------------------------------------------------------------------
# The controller.


@dataclass
class MaintenanceResult:
    """One maintenance pass's outcome summary."""

    target: str = ""
    groups: int = 0
    phases: Dict[str, int] = field(default_factory=dict)
    transitions: List[Tuple[str, str]] = field(default_factory=list)
    draining: int = 0
    cordoned_hosts: int = 0
    patches: int = 0
    blocked_on: str = ""  # first pending group the budget held back
    complete: bool = False
    wave_completed: bool = False  # complete became True THIS pass
    published: bool = False

    def line(self) -> str:
        bits = [f"{self.groups} group(s) -> {self.target}"]
        if self.phases:
            bits.append(" ".join(f"{p}={self.phases[p]}"
                                 for p in PHASES if self.phases.get(p)))
        if self.transitions:
            bits.append("transitions: " + ", ".join(
                f"{g}->{p}" for g, p in self.transitions))
        if self.draining:
            bits.append(f"{self.draining} gang(s) draining")
        if self.blocked_on:
            bits.append(f"budget holds {self.blocked_on}")
        if self.patches:
            bits.append(f"{self.patches} node patch(es)")
        if self.published:
            bits.append("state published")
        if self.complete:
            bits.append("wave complete")
        return "maintenance: " + "; ".join(bits)


class MaintenanceController:
    """The rolling-maintenance control loop against one apiserver.

    ``step()`` is one pass (LIST nodes + jobs, GET the reservation
    table, reconcile phases under the lock, then PATCH nodes / publish
    state / emit events outside it); ``run()`` loops it. Crash-safe by
    construction: phases persist in the state ConfigMap, desired node
    state is recomputed from phases every pass, and the published-state
    memo commits only after the write lands."""

    def __init__(self, client: kubeapply.Client, namespace: str,
                 plan: Optional[WavePlan] = None,
                 telemetry: Optional[_telemetry.Telemetry] = None,
                 events: Optional[Any] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.client = client
        self.namespace = namespace
        self.plan = plan  # thread-owned: set once, read-only afterwards
        self.telemetry = telemetry
        self.events = events
        self._clock = clock
        self._lock = threading.Lock()
        self._state: Optional[WaveState] = None  # guarded-by: _lock
        self._last_published: Optional[str] = None  # guarded-by: _lock
        self._bootstrapped = False  # guarded-by: _lock
        # transition events awaiting emission: appended by _reconcile,
        # drained by step() AFTER the state publish lands — the
        # persisted phase is the exactly-once memo, so a pass that dies
        # before publishing re-derives (and re-queues) the transition
        self._pending_events: List[Tuple[str, str, str]] = []  # guarded-by: _lock
        # cordon instants per group (monotonic) feeding the
        # cordon->done wall histogram; in-memory only (a restart
        # forfeits the sample, never the wave)
        self._group_started: Dict[str, float] = {}  # guarded-by: _lock
        self.max_concurrent_drains = 0  # guarded-by: _lock (bench audit)
        self.passes = 0  # guarded-by: _lock

    # ------------------------------------------------------------- state

    def state_snapshot(self) -> Optional[WaveState]:
        with self._lock:
            if self._state is None:
                return None
            return parse_state(build_state(self._state))

    # ------------------------------------------------------------- I/O

    def _state_path(self) -> str:
        return (f"/api/v1/namespaces/{self.namespace}/configmaps/"
                f"{MAINTENANCE_CONFIGMAP}")

    def _reservation_path(self) -> str:
        return (f"/api/v1/namespaces/{self.namespace}/configmaps/"
                f"{admission.RESERVATION_CONFIGMAP}")

    def _jobs_path(self) -> str:
        return f"/apis/batch/v1/namespaces/{self.namespace}/jobs"

    def _state_ref(self) -> Dict[str, str]:
        return {"apiVersion": "v1", "kind": "ConfigMap",
                "namespace": self.namespace,
                "name": MAINTENANCE_CONFIGMAP}

    def _publish(self, payload: str) -> None:
        cm = {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {
                "name": MAINTENANCE_CONFIGMAP,
                "namespace": self.namespace,
                "labels": {"app.kubernetes.io/part-of": admission.PART_OF},
            },
            "data": {MAINTENANCE_KEY: payload},
        }
        self.client.apply(cm)

    def _maybe_bootstrap(self) -> None:
        """Recover a restarted controller's wave from the state
        ConfigMap its predecessor published (admission's recovery shape):
        finished groups stay finished — a SIGKILL'd controller resumes
        mid-wave without re-draining them. A published wave for the
        SAME target wins over the constructor plan; a different target
        (or an unparseable document) starts fresh from the plan and
        forces a canonical re-publish."""
        with self._lock:
            if self._bootstrapped:
                return
        plan = self.plan
        code, cm = self.client.get(self._state_path())
        recovered: Optional[WaveState] = None
        last: Optional[str] = None
        if code == 200:
            raw = str((cm.get("data") or {}).get(MAINTENANCE_KEY) or "")
            last = raw
            if raw:
                try:
                    recovered = parse_state(json.loads(raw))
                    last = json.dumps(build_state(recovered),
                                      sort_keys=True,
                                      separators=(",", ":"))
                except (ValueError, TypeError):
                    recovered = None
        state: Optional[WaveState] = None
        if recovered is not None and (
                plan is None or recovered.target == plan.target_version):
            state = recovered
        elif plan is not None:
            state = state_from_plan(plan)
        with self._lock:
            if self._bootstrapped:
                return
            if state is None:
                raise kubeapply.ApplyError(
                    "maintenance: no wave plan given and no published "
                    f"state in ConfigMap {MAINTENANCE_CONFIGMAP!r} — "
                    "run `maintain run` with a plan first")
            self._bootstrapped = True
            self._state = state
            self._last_published = last

    # ------------------------------------------------------------- pass

    def step(self) -> MaintenanceResult:
        """One maintenance pass (also the ``maintenance-pass`` span)."""
        tel = self.telemetry
        with _telemetry.maybe_span(tel, "maintenance-pass",
                                   "maintenance"):
            self._maybe_bootstrap()
            nodes = self.client.list_collection(admission.NODES_PATH)
            jobs = self.client.list_collection(self._jobs_path())
            live_gangs = {
                g.name for g in (admission.gang_of_job(j)
                                 for j in jobs.values())
                if g is not None}
            code, cm = self.client.get(self._reservation_path())
            table: Mapping[str, admission.Reservation] = {}
            if code == 200:
                raw = str((cm.get("data") or {})
                          .get(admission.RESERVATION_KEY) or "")
                if raw:
                    try:
                        table = admission.parse_table(json.loads(raw))
                    except (ValueError, TypeError):
                        table = {}
            views: Dict[str, NodeView] = {}
            for obj in nodes.values():
                v = node_view(obj)
                if v is not None:
                    views[v.name] = v
            now = self._clock()
            patches, publish, walls, result = self._reconcile(
                views, table, live_gangs, now)
            for path, body in patches:
                self.client.patch_merge(path, body)
            if publish is not None:
                # published-state memo commits only AFTER the write
                # lands (a failed publish is retried next pass, and the
                # transition events below stay queued until it does)
                self._publish(publish)
                with self._lock:
                    self._last_published = publish
                result.published = True
            with self._lock:
                emit = list(self._pending_events)
                self._pending_events = []
            rec = self.events
            if rec is not None:
                involved = self._state_ref()
                for reason, message, type_ in emit:
                    rec.emit(involved, reason, message, type_=type_)
            if tel is not None:
                for _g, phase in result.transitions:
                    tel.counter(
                        _telemetry.MAINTENANCE_TRANSITIONS_TOTAL,
                        "maintenance wave-group phase transitions",
                        phase=phase).inc()
                tel.gauge(_telemetry.MAINTENANCE_DRAINING_GANGS,
                          "gangs currently drained by maintenance"
                          ).set(float(result.draining))
                tel.gauge(_telemetry.MAINTENANCE_CORDONED_HOSTS,
                          "hosts currently cordoned for maintenance"
                          ).set(float(result.cordoned_hosts))
                for wall in walls:
                    tel.histogram(
                        _telemetry.MAINTENANCE_GROUP_SECONDS,
                        "cordon->done wall per host group"
                    ).observe(wall)
                if result.wave_completed:
                    tel.counter(_telemetry.MAINTENANCE_WAVES_TOTAL,
                                "completed maintenance wave plans").inc()
                tel.event("maintenance-result", groups=result.groups,
                          draining=result.draining,
                          transitions=len(result.transitions),
                          complete=result.complete)
        return result

    def _reconcile(self, views: Mapping[str, NodeView],
                   table: Mapping[str, admission.Reservation],
                   live_gangs: "set[str]", now: float
                   ) -> Tuple[List[Tuple[str, Dict[str, Any]]],
                              Optional[str], List[float],
                              MaintenanceResult]:
        """The pure half of a pass: advance phases and decide what to
        write (node patches, state payload) WITHOUT doing any I/O.
        Transitions pending->cordoned are budget-gated decisions; every
        other transition is observed from cluster state. Node patches
        are level-triggered desired state — recomputed from phases, so
        lost writes (crash, chaos) are re-issued until observed."""
        result = MaintenanceResult()
        patches: List[Tuple[str, Dict[str, Any]]] = []
        walls: List[float] = []
        with self._lock:
            self.passes += 1
            state = self._state
            assert state is not None  # _maybe_bootstrap ran
            result.target = state.target
            result.groups = len(state.groups)
            ordered = sorted(state.groups, key=_group_key)
            active_hosts: "set[str]" = set()
            for name in ordered:
                gs = state.groups[name]
                if gs.phase in _ACTIVE_PHASES:
                    active_hosts.update(gs.hosts)

            # 1. draining bookkeeping: a gang seated on an active
            # group's hosts is being drained; it stays on the books
            # until it re-admits OFF the active hosts or its Job is
            # gone (either way the disruption ended).
            for name in ordered:
                gs = state.groups[name]
                if gs.phase not in _ACTIVE_PHASES:
                    continue
                ghosts = set(gs.hosts)
                for gang, res in table.items():
                    if set(res.host_names()) & ghosts:
                        gs.draining[gang] = res.accelerator
            for name in ordered:
                gs = state.groups[name]
                for gang in list(gs.draining):
                    if gang not in live_gangs:
                        gs.draining.pop(gang, None)
                    elif gang in table and not (
                            set(table[gang].host_names())
                            & active_hosts):
                        gs.draining.pop(gang, None)

            # 2. observed transitions, one phase per group per pass
            for name in ordered:
                gs = state.groups[name]
                present = [views[h] for h in gs.hosts if h in views]
                residents = sorted(
                    gang for gang, res in table.items()
                    if set(res.host_names()) & set(gs.hosts))
                all_cordoned = bool(present) and all(
                    v.cordoned and v.note == name for v in present)
                if gs.phase == PHASE_CORDONED:
                    if all_cordoned and not residents:
                        gs.phase = PHASE_DRAINED
                        result.transitions.append((name, PHASE_DRAINED))
                        self._pending_events.append((
                            EVENT_GANG_DRAINED,
                            f"group {name}: no resident gang "
                            "reservations remain; upgrading to "
                            f"{state.target}", "Normal"))
                elif gs.phase == PHASE_DRAINED:
                    if present and all(v.version == state.target
                                       for v in present):
                        gs.phase = PHASE_UPGRADED
                        result.transitions.append((name,
                                                   PHASE_UPGRADED))
                        self._pending_events.append((
                            EVENT_UPGRADE_APPLIED,
                            f"group {name}: version label "
                            f"{state.target} applied to "
                            f"{len(present)} host(s)", "Normal"))
                elif gs.phase == PHASE_UPGRADED:
                    # the health gate: Ready AND label match, every
                    # host, before the uncordon
                    if present and all(v.ready
                                       and v.version == state.target
                                       for v in present):
                        gs.phase = PHASE_DONE
                        result.transitions.append((name, PHASE_DONE))
                        self._pending_events.append((
                            EVENT_UNCORDONED,
                            f"group {name}: healthy (Ready, version "
                            f"{state.target}); uncordoning "
                            f"{len(present)} host(s)", "Normal"))
                        started = self._group_started.pop(name, None)
                        if started is not None:
                            walls.append(max(0.0, now - started))

            # 3. budget-gated cordon starts, in wave order; stop at the
            # first group the budget holds back (waves stay ordered)
            drain_union: Dict[str, str] = {}
            for name in ordered:
                drain_union.update(state.groups[name].draining)
            active_count = sum(
                1 for name in ordered
                if state.groups[name].phase in _ACTIVE_PHASES)
            for name in ordered:
                gs = state.groups[name]
                if gs.phase != PHASE_PENDING:
                    continue
                avail_after = len(state.groups) - (active_count + 1)
                if avail_after < state.budget.min_available_groups:
                    result.blocked_on = name
                    break
                residents_acc = {
                    gang: res.accelerator
                    for gang, res in table.items()
                    if set(res.host_names()) & set(gs.hosts)}
                counts: Dict[str, int] = {}
                for acc in drain_union.values():
                    counts[acc] = counts.get(acc, 0) + 1
                adds: Dict[str, int] = {}
                for gang, acc in residents_acc.items():
                    if gang not in drain_union:
                        adds[acc] = adds.get(acc, 0) + 1
                over = any(
                    counts.get(acc, 0) + add
                    > max(state.budget.max_drained_gangs, add)
                    for acc, add in adds.items())
                if over:
                    result.blocked_on = name
                    break
                gs.phase = PHASE_CORDONED
                gs.draining.update(residents_acc)
                drain_union.update(residents_acc)
                active_count += 1
                self._group_started.setdefault(name, now)
                result.transitions.append((name, PHASE_CORDONED))
                self._pending_events.append((
                    EVENT_CORDON_STARTED,
                    f"group {name}: cordoning {len(gs.hosts)} host(s) "
                    f"for upgrade to {state.target}"
                    + (f"; draining gang(s) "
                       f"{', '.join(sorted(residents_acc))}"
                       if residents_acc else ""), "Normal"))

            # 4. level-triggered node patches from desired phase state
            for name in ordered:
                gs = state.groups[name]
                for h in gs.hosts:
                    v = views.get(h)
                    if v is None:
                        continue
                    path = f"{admission.NODES_PATH}/{h}"
                    if gs.phase in _ACTIVE_PHASES and not (
                            v.cordoned and v.note == name):
                        patches.append((path, {
                            "spec": {"unschedulable": True},
                            "metadata": {"annotations": {
                                admission.MAINTENANCE_ANNOTATION: name,
                            }}}))
                    if gs.phase in (PHASE_DRAINED, PHASE_UPGRADED) \
                            and v.version != state.target:
                        patches.append((path, {
                            "metadata": {"labels": {
                                VERSION_LABEL: state.target}}}))
                    if gs.phase == PHASE_DONE and v.note == name:
                        patches.append((path, {
                            "spec": {"unschedulable": False},
                            "metadata": {"annotations": {
                                admission.MAINTENANCE_ANNOTATION: None,
                            }}}))

            # 5. wave completion: every group done AND every planned
            # host observed uncordoned (the uncordon writes landed)
            all_done = all(state.groups[n].phase == PHASE_DONE
                           for n in ordered)
            plan_hosts = [h for n in ordered
                          for h in state.groups[n].hosts]
            if (not state.complete and all_done
                    and all(not views[h].cordoned for h in plan_hosts
                            if h in views)):
                state.complete = True
                result.wave_completed = True
                self._pending_events.append((
                    EVENT_WAVE_COMPLETE,
                    f"wave complete: {len(state.groups)} group(s) "
                    f"upgraded to {state.target} and uncordoned",
                    "Normal"))
            result.complete = state.complete
            result.draining = len(drain_union)
            self.max_concurrent_drains = max(self.max_concurrent_drains,
                                             len(drain_union))
            result.cordoned_hosts = sum(
                1 for v in views.values() if v.cordoned)
            for p in PHASES:
                result.phases[p] = sum(
                    1 for n in ordered if state.groups[n].phase == p)
            payload = json.dumps(build_state(state), sort_keys=True,
                                 separators=(",", ":"))
            publish: Optional[str] = None
            if payload != self._last_published:
                publish = payload
        result.patches = len(patches)
        return patches, publish, walls, result

    # ------------------------------------------------------------- loop

    def run(self, interval: float = 1.0,
            stop: Optional[threading.Event] = None,
            max_passes: int = 0,
            until_complete: bool = False) -> None:
        """Poll-loop the controller (``maintain run``): one pass
        per interval until ``stop`` is set, ``max_passes`` is reached,
        or (with ``until_complete``) the wave converges."""
        done = 0
        while stop is None or not stop.is_set():
            try:
                result = self.step()
                if until_complete and result.complete:
                    return
            except kubeapply.ApplyError:
                # the apiserver outlasted the retry budget this pass;
                # the loop IS the outer retry — phases persist and
                # desired state is recomputed, so nothing is lost
                pass
            done += 1
            if max_passes and done >= max_passes:
                return
            if stop is not None:
                if stop.wait(interval):
                    return
            else:
                time.sleep(interval)


# --------------------------------------------------------------------------
# Read-side view (`maintain status`): no controller needed — the
# wave state lives on the cluster.


def fetch_state(client: kubeapply.Client,
                namespace: str) -> Optional[WaveState]:
    """The published wave state, or None when no wave was ever run (or
    the document is unparseable — the next controller pass repairs
    it)."""
    code, cm = client.get(
        f"/api/v1/namespaces/{namespace}/configmaps/"
        f"{MAINTENANCE_CONFIGMAP}")
    if code != 200:
        return None
    raw = str((cm.get("data") or {}).get(MAINTENANCE_KEY) or "")
    if not raw:
        return None
    try:
        return parse_state(json.loads(raw))
    except (ValueError, TypeError):
        return None


def format_status(state: Optional[WaveState]) -> str:
    """The `maintain status` table."""
    if state is None:
        return "no maintenance wave state published"
    lines = [f"target version: {state.target}",
             f"budget: max {state.budget.max_drained_gangs} drained "
             "gang(s) per accelerator type, min "
             f"{state.budget.min_available_groups} available group(s)",
             "complete: " + ("yes" if state.complete else "no")]
    headers = ("GROUP", "PHASE", "HOSTS", "DRAINING")
    rows = []
    for name in sorted(state.groups, key=_group_key):
        gs = state.groups[name]
        rows.append((name, gs.phase, str(len(gs.hosts)),
                     ",".join(sorted(gs.draining)) or "-"))
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    lines.append("  ".join(h.ljust(widths[i])
                           for i, h in enumerate(headers)).rstrip())
    for r in rows:
        lines.append("  ".join(c.ljust(widths[i])
                               for i, c in enumerate(r)).rstrip())
    return "\n".join(lines)
