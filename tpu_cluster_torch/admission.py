"""Gang admission: all-or-nothing arbitration of multi-host GPU
workloads. The port's own copy of ``tpu_cluster/admission.py``.

The problem (Borg's task-group scheduling, Verma et al. EuroSys '15;
Kueue/JobSet in today's Kubernetes): a multi-host workload -- say an
Indexed Job spanning 2 eight-card hosts -- deadlocks if its workers seat
on cards one host at a time while a competing job grabs the rest.
Nothing in a stock device-plugin stack arbitrates; first-come is
first-DEADLOCKED.

This module is the control-plane half of the fix:

- **Gangs.** A workload opts in by annotating its Job with
  :data:`GANG_ANNOTATION` (the gang name), the host layout it needs
  (:data:`GANG_ACCELERATOR_ANNOTATION`, a ``topology.HOST_TYPES`` name
  like ``h100-sxm5-80gb-8``) and an optional integer
  :data:`GANG_PRIORITY_ANNOTATION`. The gang's host count is its Job's
  ``spec.completions`` (lint R07 holds completions == parallelism,
  Indexed mode and a whole host's cards a worker).
- **Host eligibility.** A Node serves a layout when its
  ``nvidia.com/gpu.product`` label is the layout's card (blanks as
  dashes), its ``nvidia.com/gpu.topology`` label is the layout's, and
  its ``nvidia.com/gpu`` capacity covers the layout's cards.
- **All-or-nothing admission.** :class:`AdmissionController` keeps a
  FIFO queue (priority first, then arrival): a gang is admitted only
  when EVERY host it needs can be reserved atomically. No partial
  holds, ever: a gang is either fully reserved or fully queued.
- **Priority preemption.** A higher-priority gang displaces whole
  lower-priority gangs (never a fraction of one); victims re-queue with
  a reason naming the preemptor.
- **Failure-domain recovery.** A host going NotReady drains every
  reservation touching it -- the WHOLE victim gang re-queues for
  re-admission (a half-dead gang holding cards is the deadlock this
  module exists to kill).
- **The reservation table.** Admitted reservations publish as a
  ConfigMap (:data:`RESERVATION_CONFIGMAP` / :data:`RESERVATION_KEY`)
  in the reference's schema (version 1). The reference's native device
  plugin enforces that table at ``Allocate``; NVIDIA's device plugin,
  which the GPU stack deploys, does not read it, so on a GPU host
  :func:`check_allocation` is the verdict function only.

Concurrency: one ``_lock`` guards controller state; I/O (LIST/GET/PATCH)
always happens OUTSIDE it, so the admission lock is a leaf in the
process-wide acquisition graph.
"""

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Set,
                    Tuple)

from . import kubeapply, telemetry as _telemetry, topology
from .discovery import labels as _labels
from .spec import DEFAULT_RESOURCE

# --------------------------------------------------------------------------
# The reservation-table contract: the reference's schema and annotation
# keys. The ConfigMap's name is the GPU stack's own (no native plugin of
# this stack reads it).

RESERVATION_CONFIGMAP = "gpu-gang-reservations"
RESERVATION_KEY = "reservations.json"
RESERVATION_SCHEMA_VERSION = 1
GANG_ANNOTATION = "tpu-stack.dev/gang"

# Python-only surface annotations (the request/decision halves of the
# contract).
GANG_ACCELERATOR_ANNOTATION = "tpu-stack.dev/gang-accelerator"
GANG_PRIORITY_ANNOTATION = "tpu-stack.dev/gang-priority"
GANG_STATUS_ANNOTATION = "tpu-stack.dev/gang-status"
GANG_REASON_ANNOTATION = "tpu-stack.dev/gang-reason"

STATUS_ADMITTED = "admitted"
STATUS_QUEUED = "queued"
STATUS_PREEMPTED = "preempted"

# Event reasons: one per decision transition, posted on the
# gang's Job. ReAdmitted is distinct from Admitted on purpose — the
# Drained→ReAdmitted pair on one Job is the whole drain/recovery story
# in two `events --for` rows.
EVENT_ADMITTED = "Admitted"
EVENT_READMITTED = "ReAdmitted"
EVENT_PREEMPTED = "Preempted"
EVENT_DRAINED = "Drained"

# The drain decision's reason prefix — shared between the decision text
# and the restarted-controller event-memo recovery (step() seeds
# _events_noted from live annotations so a drained gang re-admitted by
# a FRESH process still reads ReAdmitted, not Admitted).
DRAIN_REASON_PREFIX = "reservation drained"

NODES_PATH = "/api/v1/nodes"

# Maintenance orchestration: a cordoned Node carries
# ``spec.unschedulable: true`` plus this annotation naming its wave
# group ("g/0"). arbitrate() never seats a gang on a cordoned host
# (stickiness breaks, so resident gangs drain whole), and the published
# reservation table carries the cordoned-host list so
# :func:`check_allocation` refuses seats during the drain race window. The queue CLI names the wave group a pending
# gang is waiting on.
MAINTENANCE_ANNOTATION = "tpu-stack.dev/maintenance"

# Node labels a host layout is recognised by (the feature-discovery
# label set, discovery/labels.py) and the extended resource its cards
# are advertised as.
PRODUCT_LABEL = _labels.PRODUCT
TOPOLOGY_LABEL = _labels.TOPOLOGY
GPU_RESOURCE = DEFAULT_RESOURCE

# The part-of label value the port's rendered objects carry
# (render/manifests.py), stamped on the controllers' ConfigMaps.
PART_OF = "tpu-stack"


# --------------------------------------------------------------------------
# Data model.


@dataclass(frozen=True)
class GangRequest:
    """One gang-annotated workload, as read from its Job."""

    name: str
    namespace: str
    job_name: str
    accelerator: str  # the host layout, a topology.HOST_TYPES name
    priority: int = 0
    hosts: int = 1    # the Job's spec.completions: one worker a host

    @property
    def job_path(self) -> str:
        return (f"/apis/batch/v1/namespaces/{self.namespace}"
                f"/jobs/{self.job_name}")


@dataclass(frozen=True)
class HostCapacity:
    """One Node's admission-relevant state. ``accelerator`` is the host
    layout its product and topology labels name (``product/topology``
    when no registered layout matches); ``cards`` its ``nvidia.com/gpu``
    capacity."""

    name: str
    accelerator: str
    cards: int
    ready: bool
    # maintenance cordon: spec.unschedulable OR the
    # maintenance annotation; ``maintenance`` carries the annotation
    # value (the wave-group name) when present, "" otherwise
    cordoned: bool = False
    maintenance: str = ""
    product: str = ""
    topology: str = ""


@dataclass(frozen=True)
class Reservation:
    """A fully-admitted gang's atomic hold: whole host groups only."""

    gang: str
    accelerator: str
    priority: int
    # host -> reserved card indices (always the whole host, sorted)
    hosts: Tuple[Tuple[str, Tuple[int, ...]], ...]

    def host_names(self) -> Tuple[str, ...]:
        return tuple(h for h, _ids in self.hosts)


@dataclass(frozen=True)
class Decision:
    """Why a gang is where it is (surfaced via annotations + tpuctl
    queue)."""

    status: str  # admitted | queued | preempted
    reason: str


@dataclass
class PassResult:
    """One reconcile pass's outcome summary."""

    gangs: int = 0
    admitted: List[str] = field(default_factory=list)
    newly_admitted: List[str] = field(default_factory=list)
    queued: List[str] = field(default_factory=list)
    preempted: List[Tuple[str, str]] = field(default_factory=list)  # victim, by
    drained: List[str] = field(default_factory=list)
    published: bool = False

    def line(self) -> str:
        bits = [f"{self.gangs} gang(s)",
                f"{len(self.admitted)} admitted",
                f"{len(self.queued)} queued"]
        if self.newly_admitted:
            bits.append(f"newly admitted: {', '.join(self.newly_admitted)}")
        if self.preempted:
            bits.append("preempted: " + ", ".join(
                f"{v} (by {b})" for v, b in self.preempted))
        if self.drained:
            bits.append(f"drained: {', '.join(self.drained)}")
        if self.published:
            bits.append("reservations published")
        return "admission: " + "; ".join(bits)


# --------------------------------------------------------------------------
# Reservation-table (de)serialisation.


class ReservationTable(Dict[str, Reservation]):
    """The parsed ``reservations.json``: gang name -> Reservation, plus
    the cordoned-host set riding the same document (an ADDITIVE
    schema-v1 field — tables without it parse with an empty set, so old
    controllers and new plugins interoperate). ``check_allocation``
    refuses any seat on a cordoned host."""

    def __init__(self, gangs: Optional[Mapping[str, Reservation]] = None,
                 cordoned: Sequence[str] = ()) -> None:
        super().__init__(gangs or {})
        self.cordoned: Tuple[str, ...] = tuple(sorted(set(cordoned)))


def build_table(reservations: Mapping[str, Reservation],
                cordoned: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The ``reservations.json`` document for a set of admitted gangs —
    canonical form (sorted keys, sorted chip ids) so equal states render
    byte-identical and the publish path can diff cheaply. ``cordoned``
    defaults to the table's own cordon set when ``reservations`` is a
    :class:`ReservationTable` (round-trip stability); the key is OMITTED
    when empty, so pre-maintenance documents stay byte-identical."""
    if cordoned is None:
        cordoned = getattr(reservations, "cordoned", ())
    gangs: Dict[str, Any] = {}
    for name in sorted(reservations):
        res = reservations[name]
        gangs[name] = {
            "accelerator": res.accelerator,
            "priority": res.priority,
            "hosts": {h: sorted(ids) for h, ids in res.hosts},
        }
    doc: Dict[str, Any] = {"version": RESERVATION_SCHEMA_VERSION,
                           "gangs": gangs}
    cords = sorted({str(h) for h in cordoned})
    if cords:
        doc["cordoned"] = cords
    return doc


def parse_table(doc: Mapping[str, Any]) -> ReservationTable:
    """Parse a reservation document; raises ``ValueError`` on a wrong
    schema version or malformed entries (fails closed as a unit)."""
    version = doc.get("version")
    if version != RESERVATION_SCHEMA_VERSION:
        raise ValueError(
            f"reservations: unsupported schema version {version!r} "
            f"(want {RESERVATION_SCHEMA_VERSION})")
    out: Dict[str, Reservation] = {}
    gangs = doc.get("gangs") or {}
    if not isinstance(gangs, Mapping):
        raise ValueError("reservations: 'gangs' is not an object")
    for name, entry in gangs.items():
        if not isinstance(entry, Mapping):
            raise ValueError(f"reservations: gang {name!r} is not an object")
        hosts_in = entry.get("hosts") or {}
        if not isinstance(hosts_in, Mapping):
            raise ValueError(
                f"reservations: gang {name!r} 'hosts' is not an object")
        hosts: List[Tuple[str, Tuple[int, ...]]] = []
        for host, ids in sorted(hosts_in.items()):
            if (not isinstance(ids, Sequence) or isinstance(ids, str)
                    or not all(isinstance(i, int) for i in ids)):
                raise ValueError(
                    f"reservations: gang {name!r} host {host!r} chip list "
                    "is not an integer array")
            hosts.append((host, tuple(sorted(ids))))
        out[str(name)] = Reservation(
            gang=str(name),
            accelerator=str(entry.get("accelerator", "")),
            priority=int(entry.get("priority", 0)),
            hosts=tuple(hosts))
    cordoned_in = doc.get("cordoned")
    cords: List[str] = []
    if cordoned_in is not None:
        if (not isinstance(cordoned_in, Sequence)
                or isinstance(cordoned_in, str)):
            raise ValueError("reservations: 'cordoned' is not an array")
        for h in cordoned_in:
            if not isinstance(h, str):
                raise ValueError(
                    "reservations: 'cordoned' has a non-string host")
            cords.append(h)
    return ReservationTable(out, cordoned=cords)


def check_allocation(reservations: Mapping[str, Reservation], host: str,
                     device_ids: Sequence[int]) -> Tuple[bool, str]:
    """The Allocate verdict of the reference's device plugin, kept as
    the port's verdict function. Returns ``(True, gang)`` when
    ``device_ids`` is EXACTLY one admitted gang's reserved host group on
    ``host``; ``(False, reason)`` otherwise, with a partial seat named
    as such. Verdicts and wording are the reference's."""
    want = set(device_ids)
    if len(want) != len(device_ids):
        return False, "duplicate device ids in allocation request"
    # maintenance cordon beats any reservation still naming the host:
    # during the drain race window (host cordoned, admission pass not
    # yet landed) the kubelet must not seat a gang the controller is
    # about to drain. Wording is twin-pinned with reservation.cc.
    if host in getattr(reservations, "cordoned", ()):
        return False, (f"host '{host}' is cordoned for maintenance; "
                       "gangs are not seated on a cordoned host")
    host_reserved = False
    for name in sorted(reservations):
        res = reservations[name]
        for res_host, ids in res.hosts:
            if res_host != host:
                continue
            host_reserved = True
            reserved = set(ids)
            if reserved == want:
                return True, res.gang
            if want and want <= reserved:
                return False, (
                    f"partial allocation of gang '{res.gang}' on host "
                    f"'{host}': requested {len(want)} of {len(reserved)} "
                    "reserved chip(s); gangs are seated whole or not at "
                    "all")
    if host_reserved:
        return False, ("device set does not match any admitted gang "
                       f"reservation on host '{host}'")
    return False, (f"no admitted gang reservation covers host '{host}'; "
                   "the admission loop has not granted this job chips")


# --------------------------------------------------------------------------
# Cluster-state readers (Node/Job object -> model).


def _product_label(layout: topology.HostType) -> str:
    """The product label value feature discovery publishes for a
    layout's card: its name with blanks as dashes."""
    return layout.card.product.replace(" ", "-")


def _layout_of(product: str, topo: str) -> str:
    """The registered host layout a Node's product and topology labels
    name, or ``product/topology`` when none does."""
    for layout in topology.HOST_TYPES.values():
        if (_product_label(layout) == product
                and layout.label_topology() == topo):
            return layout.name
    return f"{product}/{topo}"


def host_capacity(node: Mapping[str, Any]) -> Optional[HostCapacity]:
    """A Node object's admission view, or None when it advertises no GPU
    product (non-GPU nodes are invisible to the queue)."""
    meta = node.get("metadata") or {}
    labels = meta.get("labels") or {}
    product = labels.get(PRODUCT_LABEL)
    if not product:
        return None
    topo = str(labels.get(TOPOLOGY_LABEL) or "")
    status = node.get("status") or {}
    capacity = status.get("capacity") or {}
    try:
        cards = int(str(capacity.get(GPU_RESOURCE, "0")))
    except ValueError:
        cards = 0
    ready = False
    for cond in status.get("conditions") or []:
        if isinstance(cond, Mapping) and cond.get("type") == "Ready":
            ready = str(cond.get("status")) == "True"
    spec = node.get("spec") or {}
    anns = meta.get("annotations") or {}
    maintenance = str(anns.get(MAINTENANCE_ANNOTATION) or "")
    cordoned = bool(spec.get("unschedulable")) or bool(maintenance)
    return HostCapacity(name=str(meta.get("name", "")),
                        accelerator=_layout_of(str(product), topo),
                        cards=cards, ready=ready, cordoned=cordoned,
                        maintenance=maintenance, product=str(product),
                        topology=topo)


def gang_of_job(job: Mapping[str, Any]) -> Optional[GangRequest]:
    """The gang request a Job declares via annotations, or None for
    non-gang workloads. Its host count is ``spec.completions`` (1 when
    absent or not a positive integer)."""
    meta = job.get("metadata") or {}
    anns = meta.get("annotations") or {}
    gang = anns.get(GANG_ANNOTATION)
    if not gang:
        return None
    try:
        priority = int(str(anns.get(GANG_PRIORITY_ANNOTATION, "0")))
    except ValueError:
        priority = 0
    try:
        hosts = max(1, int(str((job.get("spec") or {})
                               .get("completions", 1))))
    except ValueError:
        hosts = 1
    return GangRequest(
        name=str(gang),
        namespace=str(meta.get("namespace", "default")),
        job_name=str(meta.get("name", "")),
        accelerator=topology.canonical_name(
            str(anns.get(GANG_ACCELERATOR_ANNOTATION, ""))),
        priority=priority, hosts=hosts)


def _host_matches(host: HostCapacity, layout: topology.HostType) -> bool:
    """Host eligibility for one gang: the Node's product label is the
    layout's card, its topology label the layout's, and its capacity
    covers the layout's cards -- the reference's generation, per-host
    grid and capacity test, on the labels feature discovery publishes."""
    return (host.product == _product_label(layout)
            and host.topology == layout.label_topology()
            and host.cards >= layout.cards_per_host)


# --------------------------------------------------------------------------
# The arbitration: a deterministic greedy recompute.


@dataclass
class Arbitration:
    admitted: Dict[str, Reservation]
    decisions: Dict[str, Decision]


def arbitrate(hosts: Sequence[HostCapacity], gangs: Sequence[GangRequest],
              previous: Mapping[str, Reservation],
              arrival: Mapping[str, float]) -> Arbitration:
    """One admission pass, recomputed from scratch: rank every live gang
    by (priority desc, arrival, name) and admit greedily, whole gangs
    only. Stickiness: an already-admitted gang keeps its exact hosts
    when they are still eligible (no churn); a higher-priority newcomer
    naturally displaces lower-priority holders because it ranks first in
    the recompute — that IS the preemption, and it is all-or-nothing on
    both sides by construction."""
    ranked = sorted(
        gangs, key=lambda g: (-g.priority,
                              arrival.get(g.name, float("inf")), g.name))
    taken: Set[str] = set()
    admitted: Dict[str, Reservation] = {}
    decisions: Dict[str, Decision] = {}
    host_by_name = {h.name: h for h in hosts}
    # Displacement cost per host: a preempting newcomer must take FREE
    # hosts first, then the lowest-priority holder's — so preemption
    # evicts the least important gang, never a higher-priority bystander
    # whose hosts merely sort first.
    live = {g.name for g in gangs}
    prev_holder_prio: Dict[str, int] = {}
    for res in previous.values():
        if res.gang not in live:
            continue
        for h in res.host_names():
            prev_holder_prio[h] = max(prev_holder_prio.get(h, res.priority),
                                      res.priority)
    for g in ranked:
        if g.name in decisions:  # duplicate gang name: first request wins
            continue
        try:
            acc = topology.get_host(g.accelerator)
        except KeyError:
            decisions[g.name] = Decision(
                STATUS_QUEUED,
                f"unknown accelerator type {g.accelerator!r}; see the "
                "topology catalogue")
            continue
        eligible = sorted(
            h.name for h in hosts
            if h.ready and not h.cordoned and h.name not in taken
            and _host_matches(h, acc))
        need = g.hosts
        if len(eligible) < need:
            reason = (
                f"waiting for {need} x {acc.cards_per_host}-card host(s) "
                f"for {acc.name}; {len(eligible)} eligible host(s) free")
            # name the maintenance wave holding capacity back: a gang pending BECAUSE matching hosts are
            # cordoned should say so, not just "0 eligible"
            groups = sorted({h.maintenance or h.name for h in hosts
                             if h.cordoned and _host_matches(h, acc)})
            if groups:
                reason += ("; waiting on cordoned host group "
                           + ", ".join(groups[:4])
                           + (" ..." if len(groups) > 4 else ""))
            decisions[g.name] = Decision(STATUS_QUEUED, reason)
            continue
        prev = previous.get(g.name)
        chosen: List[str]
        if prev is not None and all(
                h in host_by_name and host_by_name[h].ready
                and (h in eligible) for h in prev.host_names()) \
                and len(prev.host_names()) == need:
            chosen = list(prev.host_names())
        else:
            chosen = sorted(
                eligible,
                key=lambda h: (prev_holder_prio.get(h, -1), h))[:need]
        taken.update(chosen)
        cards = tuple(range(acc.cards_per_host))
        admitted[g.name] = Reservation(
            gang=g.name, accelerator=acc.name, priority=g.priority,
            hosts=tuple((h, cards) for h in sorted(chosen)))
        decisions[g.name] = Decision(
            STATUS_ADMITTED,
            f"reserved {need} host group(s): {', '.join(sorted(chosen))}")
    return Arbitration(admitted=admitted, decisions=decisions)


def _drain_reason(host: str, cause: str) -> str:
    """The queued-decision reason for a drained gang. Shares
    :data:`DRAIN_REASON_PREFIX` across BOTH drain causes (failure and
    maintenance) so a fresh process's event-memo recovery treats either
    as Drained; the cause wording differs so the operator (and the
    ReAdmitted event) can tell them apart."""
    what = ("cordoned for maintenance" if cause == "cordoned"
            else "NotReady")
    return (f"{DRAIN_REASON_PREFIX}: host {host} {what}; "
            "re-queued for re-admission")


# --------------------------------------------------------------------------
# The controller.


class AdmissionController:
    """The gang-admission control loop against one apiserver.

    ``step()`` is one reconcile pass (LIST nodes + Jobs, arbitrate,
    publish the reservation ConfigMap, annotate Jobs with their
    decision); ``run()`` loops it. All apiserver I/O happens outside
    ``_lock`` — the lock guards pure state and never nests."""

    def __init__(self, client: kubeapply.Client, namespace: str,
                 telemetry: Optional[_telemetry.Telemetry] = None,
                 informers: Optional[Any] = None,
                 events: Optional[Any] = None) -> None:
        self.client = client
        self.namespace = namespace
        self.telemetry = telemetry
        # Events pipeline: an events.EventRecorder. Each
        # admission DECISION TRANSITION (Admitted / Preempted / Drained
        # / ReAdmitted) lands exactly one correlated Event on the
        # gang's Job — the operator-facing record that until now lived
        # only in the gang-reason annotation. FIRE-AND-FORGET by
        # design: the emission memo commits when the emit is attempted,
        # not when it lands, so a failed Event post is NEVER re-sent by
        # the controller loop (the recorder's fail-open contract,
        # the tests hold) — unlike the annotations above,
        # which ARE re-sent until they land. None (default) = no
        # events, byte-identical passes.
        self.events = events
        # Watch-driven mode: an informer.InformerSet holding
        # the nodes + jobs collections. When attached (and synced),
        # _read_cluster reads SNAPSHOTS instead of LISTing — a pass
        # costs zero apiserver reads, and run_watch wakes on events
        # instead of polling. None (default) = the poll shape.
        self.informers = informers
        self._lock = threading.Lock()
        self._admitted: Dict[str, Reservation] = {}  # guarded-by: _lock
        self._decisions: Dict[str, Decision] = {}  # guarded-by: _lock
        # first-seen + queued-since instants (monotonic) per gang name;
        # queued_since feeds the gang-wait histogram on admission
        self._first_seen: Dict[str, float] = {}  # guarded-by: _lock
        self._queued_since: Dict[str, float] = {}  # guarded-by: _lock
        self._last_published: Optional[str] = None  # guarded-by: _lock
        self._last_annotations: Dict[str, Tuple[str, str]] = {}  # guarded-by: _lock
        # last Event reason ATTEMPTED per gang (fire-and-forget memo —
        # see the `events` comment above); also how ReAdmitted is told
        # apart from Admitted (a gang whose last event was Drained/
        # Preempted comes BACK as ReAdmitted)
        self._events_noted: Dict[str, str] = {}  # guarded-by: _lock
        # drain-cause memo: gang -> (host, cause,
        # conditions-active-last-pass). Keeps a drained gang's queued
        # reason on the DRAIN_REASON_PREFIX wording while it waits (so a
        # FRESH process recovers ReAdmitted-not-Admitted from the
        # annotation) and tracks the LATEST cause when failure-drain and
        # maintenance-drain compose on the same host.
        self._drain_cause: Dict[str, Tuple[str, str, Set[str]]] = {}  # guarded-by: _lock
        self._bootstrapped = False  # guarded-by: _lock
        self.passes = 0  # guarded-by: _lock

    # ------------------------------------------------------------- state

    def admitted_snapshot(self) -> Dict[str, Reservation]:
        with self._lock:
            return dict(self._admitted)

    def decisions_snapshot(self) -> Dict[str, Decision]:
        with self._lock:
            return dict(self._decisions)

    # ------------------------------------------------------------- I/O

    def _jobs_path(self) -> str:
        return f"/apis/batch/v1/namespaces/{self.namespace}/jobs"

    def _read_cluster(self) -> Tuple[List[HostCapacity], List[GangRequest],
                                     Dict[str, Mapping[str, Any]]]:
        if self.informers is not None:
            # watch-driven: the informer caches ARE the cluster view —
            # an idle pass costs zero LISTs (the O(events) contract,
            # the informer tests hold). Guard BEFORE reading: a
            # dead informer's cache is frozen and an unsynced one is
            # EMPTY — arbitrating over either would see zero live gangs
            # and publish an empty reservation table, un-seating every
            # admitted gang at the Allocate enforcement point.
            # run_watch() syncs before its first pass; a caller driving
            # step() directly must wait_synced() first.
            self.informers.check()
            if not self.informers.synced():
                raise kubeapply.ApplyError(
                    "admission: informer cache not synced — call "
                    "InformerSet.wait_synced() before step()")
            nodes = self.informers.snapshot(NODES_PATH)
            jobs = self.informers.snapshot(self._jobs_path())
        else:
            nodes = self.client.list_collection(NODES_PATH)
            jobs = self.client.list_collection(self._jobs_path())
        hosts = [h for h in (host_capacity(n) for n in nodes.values())
                 if h is not None]
        gangs: List[GangRequest] = []
        by_job: Dict[str, Mapping[str, Any]] = {}
        for obj in jobs.values():
            g = gang_of_job(obj)
            if g is not None:
                gangs.append(g)
                by_job[g.name] = obj
        return hosts, gangs, by_job

    def _configmap_path(self) -> str:
        return (f"/api/v1/namespaces/{self.namespace}/configmaps/"
                f"{RESERVATION_CONFIGMAP}")

    def _publish(self, payload: str) -> None:
        cm = {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {
                "name": RESERVATION_CONFIGMAP,
                "namespace": self.namespace,
                "labels": {"app.kubernetes.io/part-of": PART_OF},
            },
            "data": {RESERVATION_KEY: payload},
        }
        self.client.apply(cm)

    # ------------------------------------------------------------- pass

    def step(self) -> PassResult:
        """One admission pass. Returns the summary (also surfaced as the
        ``admission-pass`` span in the trace)."""
        tel = self.telemetry
        with _telemetry.maybe_span(tel, "admission-pass", "admission"):
            self._maybe_bootstrap()
            hosts, gangs, jobs = self._read_cluster()
            self._seed_event_memo(jobs)
            now = time.monotonic()
            publish_payload, annotate, emit_events, result = \
                self._reconcile(hosts, gangs, now)
            if publish_payload is not None:
                # commit the published-state memo only AFTER the write
                # lands: a failed publish must be retried next pass, not
                # latched as done (an admitted gang whose table never
                # reached the cluster could otherwise never seat)
                self._publish(publish_payload)
                with self._lock:
                    self._last_published = publish_payload
                result.published = True
            for gang_name, path, status, reason in annotate:
                code, _body = self.client.patch_merge(path, {
                    "metadata": {"annotations": {
                        GANG_STATUS_ANNOTATION: status,
                        GANG_REASON_ANNOTATION: reason,
                    }}})
                if 200 <= code < 300:
                    # same discipline: only a LANDED annotation is
                    # remembered — a 403/404 (non-retryable, returned
                    # rather than raised) is re-attempted next pass
                    with self._lock:
                        self._last_annotations[gang_name] = (status,
                                                             reason)
            # decision-transition Events, OUTSIDE the lock and
            # fire-and-forget: the memo already committed in
            # _reconcile, so a failed post is never re-sent
            rec = self.events
            if rec is not None:
                for gang_name, ev_reason, ev_message, ev_type in \
                        emit_events:
                    involved = jobs.get(gang_name)
                    if involved is not None:
                        rec.emit(involved, ev_reason, ev_message,
                                 type_=ev_type)
            if tel is not None:
                tel.event("admission-result", gangs=result.gangs,
                          admitted=len(result.admitted),
                          queued=len(result.queued),
                          preempted=len(result.preempted))
        return result

    def _maybe_bootstrap(self) -> None:
        """Recover a restarted controller's state from the reservation
        ConfigMap its predecessor published: the admission loop must be
        crash-restartable WITHOUT forgetting who holds cards — a fresh
        process that ignored existing reservations would double-book the
        fleet (or fail to drain a dead host's gang). An unparseable
        table recovers as EMPTY but still forces a re-publish (the next
        pass overwrites the corruption with canonical state)."""
        with self._lock:
            if self._bootstrapped:
                return
        code, cm = self.client.get(self._configmap_path())
        recovered: Dict[str, Reservation] = {}
        last: Optional[str] = None
        if code == 200:
            raw = str((cm.get("data") or {}).get(RESERVATION_KEY) or "")
            last = raw
            if raw:
                try:
                    recovered = parse_table(json.loads(raw))
                    last = json.dumps(build_table(recovered),
                                      sort_keys=True,
                                      separators=(",", ":"))
                except (ValueError, TypeError):
                    recovered = {}
        with self._lock:
            if not self._bootstrapped:
                self._bootstrapped = True
                self._admitted = recovered
                self._last_published = last

    def _seed_event_memo(self, jobs: Mapping[str, Mapping[str, Any]]
                         ) -> None:
        """Recover the fire-and-forget event memo for gangs this
        process has never decided on: every `admission --once`
        is a fresh process, so without recovery a gang the PREDECESSOR
        drained/preempted would come back as plain Admitted instead of
        ReAdmitted. The predecessor's decision is read from the gang
        Job's live annotations (the same state the queue CLI renders);
        a gang with no decision annotation seeds nothing — its next
        transition emits normally."""
        if self.events is None:
            return
        with self._lock:
            for name, job in jobs.items():
                if name in self._events_noted:
                    continue
                anns = ((job.get("metadata") or {})
                        .get("annotations") or {})
                status = str(anns.get(GANG_STATUS_ANNOTATION, ""))
                reason = str(anns.get(GANG_REASON_ANNOTATION, ""))
                if status == STATUS_PREEMPTED:
                    self._events_noted[name] = EVENT_PREEMPTED
                elif status == STATUS_QUEUED and \
                        reason.startswith(DRAIN_REASON_PREFIX):
                    self._events_noted[name] = EVENT_DRAINED
                    # recover the drain CAUSE too, so the eventual
                    # ReAdmitted event still names what blocked the
                    # gang even across a controller restart
                    m = re.search(r"host (\S+) (NotReady|cordoned)",
                                  reason)
                    if m is not None and name not in self._drain_cause:
                        cause = ("cordoned" if m.group(2) == "cordoned"
                                 else "NotReady")
                        self._drain_cause[name] = (m.group(1), cause,
                                                   {cause})
                elif status == STATUS_ADMITTED:
                    self._events_noted[name] = EVENT_ADMITTED

    @staticmethod
    def _host_conditions(host: Optional[HostCapacity]) -> Set[str]:
        """The drain-relevant conditions active on one host (empty when
        the Node is gone from the cluster view)."""
        active: Set[str] = set()
        if host is None:
            return active
        if not host.ready:
            active.add("NotReady")
        if host.cordoned:
            active.add("cordoned")
        return active

    def _reconcile(self, hosts: Sequence[HostCapacity],
                   gangs: Sequence[GangRequest], now: float
                   ) -> Tuple[Optional[str],
                              List[Tuple[str, str, str, str]],
                              List[Tuple[str, str, str, str]], PassResult]:
        """The pure half of a pass: arbitrate under the lock and decide
        what to write (ConfigMap payload, per-Job annotations, decision
        Events) WITHOUT doing any I/O. Returns (payload-or-None,
        [(gang, job_path, status, reason)], [(gang, event_reason,
        message, event_type)], result). The written-state memos
        (_last_published / _last_annotations) are NOT updated here —
        step() commits them only after the corresponding write lands, so
        a failed write is retried on the next pass instead of being
        latched as done. The EVENT memo (_events_noted) is the
        deliberate exception: it commits here, before any I/O, because
        events are fire-and-forget — a failed post must NOT be
        re-attempted by the next pass (the fail-open pin)."""
        tel = self.telemetry
        result = PassResult(gangs=len(gangs))
        with self._lock:
            self.passes += 1
            for g in gangs:
                self._first_seen.setdefault(g.name, now)
                self._queued_since.setdefault(g.name, now)
            live = {g.name for g in gangs}
            previous = dict(self._admitted)
            ready_hosts = {h.name for h in hosts if h.ready}
            cordoned_hosts = {h.name for h in hosts if h.cordoned}
            host_by_name = {h.name: h for h in hosts}
            outcome = arbitrate(hosts, gangs, previous, self._first_seen)
            # classify transitions against the previous pass
            for name, prev_res in previous.items():
                if name in outcome.admitted or name not in live:
                    continue
                lost_ready = [h for h in prev_res.host_names()
                              if h not in ready_hosts]
                lost_cordoned = [h for h in prev_res.host_names()
                                 if h in cordoned_hosts]
                if lost_ready or lost_cordoned:
                    result.drained.append(name)
                    # a dead host outranks a cordoned one as the drain
                    # cause; the sticky memo below flips to the LATEST
                    # cause if the other condition arrives afterwards
                    if lost_ready:
                        chost, cause = lost_ready[0], "NotReady"
                    else:
                        chost, cause = lost_cordoned[0], "cordoned"
                    self._drain_cause[name] = (
                        chost, cause, self._host_conditions(
                            host_by_name.get(chost)))
                    outcome.decisions[name] = Decision(
                        STATUS_QUEUED, _drain_reason(chost, cause))
                else:
                    new_holders = sorted(
                        o.gang for o in outcome.admitted.values()
                        if o.gang != name
                        and set(o.host_names()) & set(prev_res.host_names())
                        and o.gang not in previous)
                    if new_holders:
                        result.preempted.append((name, new_holders[0]))
                        outcome.decisions[name] = Decision(
                            STATUS_PREEMPTED,
                            "preempted by higher-priority gang "
                            f"'{new_holders[0]}'")
            # sticky drain reasons: while a drained gang
            # stays queued on its blocking host, its decision keeps the
            # DRAIN_REASON_PREFIX wording — and flips to the LATEST
            # cause when failure-drain and maintenance-drain compose (a
            # cordoned host dying mid-drain reads NotReady, the fresher
            # fact; vice versa reads cordoned). A condition is "newer"
            # when it was absent at the previous observation.
            for name in list(self._drain_cause):
                if name not in live:
                    self._drain_cause.pop(name, None)
                    continue
                if name in outcome.admitted or name in result.drained:
                    continue
                chost, cause, prev_active = self._drain_cause[name]
                active = self._host_conditions(host_by_name.get(chost))
                newly = active - prev_active
                if newly:
                    cause = sorted(newly)[0]
                elif active and cause not in active:
                    cause = sorted(active)[0]
                self._drain_cause[name] = (chost, cause, active)
                if active:
                    outcome.decisions[name] = Decision(
                        STATUS_QUEUED, _drain_reason(chost, cause))
            # metric facts are COLLECTED under the lock and emitted after
            # it: the admission lock must stay a leaf (never held across
            # a telemetry-lock acquisition)
            admit_waits: List[Tuple[str, float]] = []
            for name in outcome.admitted:
                if name not in previous:
                    result.newly_admitted.append(name)
                    waited = now - self._queued_since.pop(name, now)
                    admit_waits.append(
                        (outcome.admitted[name].accelerator, waited))
                else:
                    self._queued_since.pop(name, None)
            for name in list(self._first_seen):
                if name not in live:
                    self._first_seen.pop(name, None)
                    self._queued_since.pop(name, None)
            self._admitted = outcome.admitted
            self._decisions = {n: d for n, d in outcome.decisions.items()
                               if n in live}
            result.admitted = sorted(outcome.admitted)
            result.queued = sorted(live - set(outcome.admitted))
            # the publish decision: canonical payload, diffed against the
            # last write; an empty table is only worth a mutation when a
            # non-empty one was published before (the no-gangs hot path
            # must stay request-free)
            payload = json.dumps(
                build_table(outcome.admitted,
                            cordoned=sorted(cordoned_hosts)),
                sort_keys=True, separators=(",", ":"))
            publish: Optional[str] = None
            if payload != self._last_published and (
                    outcome.admitted or self._last_published is not None):
                publish = payload
            annotate: List[Tuple[str, str, str, str]] = []
            for g in gangs:
                d = outcome.decisions.get(g.name)
                if d is None:
                    continue
                if self._last_annotations.get(g.name) != (d.status,
                                                          d.reason):
                    annotate.append((g.name, g.job_path, d.status,
                                     d.reason))
            for name in list(self._last_annotations):
                if name not in live:
                    self._last_annotations.pop(name, None)
            # decision-transition Events: computed (and MEMO-COMMITTED)
            # under the lock, emitted by step() after it. newly_admitted
            # reads the memo BEFORE overwriting, so a gang whose last
            # event was Drained/Preempted comes back as ReAdmitted.
            emit: List[Tuple[str, str, str, str]] = []
            if self.events is not None:
                for name in result.drained:
                    if self._events_noted.get(name) != EVENT_DRAINED:
                        self._events_noted[name] = EVENT_DRAINED
                        emit.append((name, EVENT_DRAINED,
                                     outcome.decisions[name].reason,
                                     "Warning"))
                for victim, _by in result.preempted:
                    if self._events_noted.get(victim) != EVENT_PREEMPTED:
                        self._events_noted[victim] = EVENT_PREEMPTED
                        emit.append((victim, EVENT_PREEMPTED,
                                     outcome.decisions[victim].reason,
                                     "Warning"))
                for name in result.newly_admitted:
                    prev = self._events_noted.get(name)
                    came_back = prev in (EVENT_DRAINED, EVENT_PREEMPTED)
                    ev_reason = (EVENT_READMITTED if came_back
                                 else EVENT_ADMITTED)
                    if prev != ev_reason:
                        self._events_noted[name] = ev_reason
                        message = outcome.decisions[name].reason
                        if came_back:
                            # name what the gang recovered FROM — the
                            # operator-facing half of the story, and
                            # what keeps back-to-back recoveries from
                            # aggregating into one counted Event. A
                            # drain recovery names the LATEST cause the
                            # memo tracked (maintenance cordon vs
                            # NotReady — they compose, one recovery).
                            cause = ("drain" if prev == EVENT_DRAINED
                                     else "preemption")
                            detail = ""
                            if (prev == EVENT_DRAINED
                                    and name in self._drain_cause):
                                chost, dcause, _act = \
                                    self._drain_cause[name]
                                what = ("maintenance cordon"
                                        if dcause == "cordoned"
                                        else "NotReady")
                                detail = f" (host {chost} {what})"
                            message = (f"re-admitted after {cause}"
                                       f"{detail}: {message}")
                        emit.append((name, ev_reason, message, "Normal"))
                for name in list(self._events_noted):
                    if name not in live:
                        self._events_noted.pop(name, None)
            for name in result.newly_admitted:
                self._drain_cause.pop(name, None)
        if tel is not None:
            for accelerator, waited in admit_waits:
                tel.histogram(
                    _telemetry.GANG_WAIT_SECONDS,
                    "seconds gangs waited in the admission queue"
                ).observe(waited)
                tel.counter(_telemetry.ADMISSIONS_TOTAL,
                            "gangs admitted all-or-nothing",
                            accelerator=accelerator).inc()
            for _victim, _by in result.preempted:
                tel.counter(_telemetry.PREEMPTIONS_TOTAL,
                            "whole-gang priority preemptions").inc()
        return publish, annotate, emit, result

    # ------------------------------------------------------------- loop

    def run(self, interval: float = 1.0,
            stop: Optional[threading.Event] = None,
            max_passes: int = 0) -> None:
        """Poll-loop the controller (``admission``): one pass per
        interval until ``stop`` is set (or ``max_passes`` reached)."""
        done = 0
        while stop is None or not stop.is_set():
            try:
                self.step()
            except kubeapply.ApplyError:
                # the apiserver outlasted the retry budget this pass; the
                # loop IS the outer retry — written-state memos commit
                # only after their writes land, so the next tick re-reads
                # the world and re-sends anything that didn't
                pass
            done += 1
            if max_passes and done >= max_passes:
                return
            if stop is not None:
                if stop.wait(interval):
                    return
            else:
                time.sleep(interval)

    def build_informers(self, page_limit: int = 0,
                        window_s: int = 30) -> Any:
        """Construct (and attach) the watch-driven cluster view: one
        informer each for the Node collection and this namespace's Jobs,
        sharing one wake signal. Caller starts/stops it (or uses
        :meth:`run_watch`, which does both)."""
        from . import informer as informermod
        limit = page_limit or informermod.DEFAULT_PAGE_LIMIT
        self.informers = informermod.InformerSet(
            self.client, [NODES_PATH, self._jobs_path()],
            telemetry=self.telemetry, page_limit=limit,
            window_s=window_s, events=self.events)
        return self.informers

    def run_watch(self, resync: float = 30.0,
                  stop: Optional[threading.Event] = None,
                  max_passes: int = 0,
                  on_pass: Optional[Any] = None) -> None:
        """The event-driven loop (``admission --watch``): sync
        the informers, arbitrate once, then re-arbitrate ONLY when a
        watch event lands (or the ``resync`` interval elapses as a
        backstop) — O(events) per wake instead of O(nodes) per tick; an
        idle fleet costs zero apiserver reads between passes."""
        informers = self.informers
        own = informers is None
        if own:
            # inherit the client's --page-limit: the flag advertises
            # bounding exactly this sync (0/None -> the informer default)
            informers = self.build_informers(
                page_limit=self.client.list_page_limit or 0)
        assert informers is not None
        try:
            if own:
                informers.start()
            if not informers.wait_synced(timeout=max(resync, 30.0)):
                raise kubeapply.ApplyError(
                    "admission informers never synced")
            done = 0
            while stop is None or not stop.is_set():
                # a dead informer means the cache is FROZEN: raising
                # here (NOT swallowed below — the swallow is for
                # transient publish failures) beats silently draining
                # gangs against a stale world forever
                informers.check()
                try:
                    result = self.step()
                    if on_pass is not None:
                        on_pass(result)
                except kubeapply.ApplyError:
                    pass  # the loop is the outer retry, like run()
                done += 1
                if max_passes and done >= max_passes:
                    return
                informers.wait_any_event(resync)
        finally:
            if own:
                informers.stop()
                self.informers = None


# --------------------------------------------------------------------------
# Read-side view (`queue`): no controller needed — the queue state
# lives on the cluster (Job annotations + the reservation ConfigMap).


@dataclass(frozen=True)
class GangView:
    """One gang as `queue` shows it."""

    name: str
    accelerator: str
    priority: int
    status: str
    reason: str
    hosts: Tuple[Tuple[str, Tuple[int, ...]], ...]
    job: str

    def host_summary(self) -> str:
        return ",".join(h for h, _ids in self.hosts) or "-"


def fetch_queue(client: kubeapply.Client,
                namespace: str) -> List[GangView]:
    """The cluster's current gang queue: gang-annotated Jobs joined with
    the published reservation table. Sorted admitted first, then by
    (priority desc, name) — the order the queue drains in."""
    jobs = client.list_collection(
        f"/apis/batch/v1/namespaces/{namespace}/jobs")
    code, cm = client.get(
        f"/api/v1/namespaces/{namespace}/configmaps/"
        f"{RESERVATION_CONFIGMAP}")
    reservations: Dict[str, Reservation] = {}
    if code == 200:
        raw = ((cm.get("data") or {}).get(RESERVATION_KEY) or "")
        if raw:
            try:
                reservations = parse_table(json.loads(raw))
            except (ValueError, TypeError):
                reservations = {}
    views: List[GangView] = []
    for obj in jobs.values():
        g = gang_of_job(obj)
        if g is None:
            continue
        anns = (obj.get("metadata") or {}).get("annotations") or {}
        res = reservations.get(g.name)
        status = str(anns.get(GANG_STATUS_ANNOTATION,
                              STATUS_ADMITTED if res else STATUS_QUEUED))
        views.append(GangView(
            name=g.name, accelerator=g.accelerator, priority=g.priority,
            status=status,
            reason=str(anns.get(GANG_REASON_ANNOTATION, "")),
            hosts=res.hosts if res is not None else (),
            job=f"{g.namespace}/{g.job_name}"))
    views.sort(key=lambda v: (v.status != STATUS_ADMITTED, -v.priority,
                              v.name))
    return views


def format_queue(views: Sequence[GangView]) -> str:
    """The `queue` table."""
    headers = ("GANG", "ACCELERATOR", "PRIORITY", "STATUS", "HOSTS",
               "REASON")
    rows = [(v.name, v.accelerator, str(v.priority), v.status,
             v.host_summary(), v.reason or "-") for v in views]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.ljust(widths[i])
                       for i, h in enumerate(headers)).rstrip()]
    for r in rows:
        lines.append("  ".join(c.ljust(widths[i])
                               for i, c in enumerate(r)).rstrip())
    if not rows:
        lines.append("(no gang-annotated jobs)")
    return "\n".join(lines)


def describe_gang(views: Sequence[GangView], name: str) -> str:
    """`queue GANG`: the one-gang detail block."""
    for v in views:
        if v.name != name:
            continue
        lines = [f"gang:        {v.name}",
                 f"job:         {v.job}",
                 f"accelerator: {v.accelerator}",
                 f"priority:    {v.priority}",
                 f"status:      {v.status}"]
        if v.reason:
            lines.append(f"reason:      {v.reason}")
        if v.hosts:
            lines.append("reservation:")
            for host, ids in v.hosts:
                lines.append(
                    f"  {host}: cards {','.join(map(str, ids))}")
        return "\n".join(lines)
    known = ", ".join(sorted(v.name for v in views)) or "none"
    return f"gang {name!r} not found (known: {known})"


def fetch_cordoned(client: kubeapply.Client) -> List[Tuple[str, str]]:
    """Cordoned GPU hosts as ``[(host, wave-group-or-'-')]`` — the
    maintenance state `queue` appends under the gang table so a
    pending gang's "waiting on cordoned host group" reason has a
    cluster-side answer."""
    nodes = client.list_collection(NODES_PATH)
    out: List[Tuple[str, str]] = []
    for obj in nodes.values():
        h = host_capacity(obj)
        if h is not None and h.cordoned:
            out.append((h.name, h.maintenance or "-"))
    return sorted(out)


def format_cordoned(cordoned: Sequence[Tuple[str, str]]) -> str:
    """The cordon footer under `queue`: one line per wave group
    naming its cordoned hosts (empty string when nothing is cordoned)."""
    if not cordoned:
        return ""
    by_group: Dict[str, List[str]] = {}
    for host, group in cordoned:
        by_group.setdefault(group, []).append(host)
    lines = ["cordoned for maintenance:"]
    for group in sorted(by_group):
        hosts = sorted(by_group[group])
        shown = ", ".join(hosts[:6]) + (" ..." if len(hosts) > 6 else "")
        lines.append(f"  group {group}: {len(hosts)} host(s) — {shown}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# Manifest helpers (tests, bench, CI e2e, and the rendered multihost Jobs
# all build gang objects from one place).


def node_manifest(name: str, accelerator: str,
                  ready: bool = True) -> Dict[str, Any]:
    """A Node object as the feature-discovery + kubelet pair would
    publish it for the host layout ``accelerator``: the discovery labels,
    the layout's ``nvidia.com/gpu`` capacity, and the Ready and GpuReady
    conditions."""
    from .discovery import labeler
    from .discovery.devices import GpuDevice

    layout = topology.get_host(accelerator)
    cards = [GpuDevice(index=i, path=f"/dev/nvidia{i}")
             for i in range(layout.cards_per_host)]
    labels = {k: v for k, v in
              _labels.compute_labels(layout.name, cards, name).items()
              if v is not None}
    count = str(layout.cards_per_host)
    return {
        "apiVersion": "v1", "kind": "Node",
        "metadata": {"name": name, "labels": labels},
        "status": {
            "capacity": {GPU_RESOURCE: count},
            "allocatable": {GPU_RESOURCE: count},
            "conditions": [
                {"type": "Ready",
                 "status": "True" if ready else "False"},
                labeler.gpu_ready_condition(layout.name, len(cards)),
            ],
        },
    }


def gang_annotations(gang: str, accelerator: str,
                     priority: int = 0) -> Dict[str, str]:
    """The annotation triple a workload opts into gang admission with."""
    return {
        GANG_ANNOTATION: gang,
        GANG_ACCELERATOR_ANNOTATION: topology.canonical_name(accelerator),
        GANG_PRIORITY_ANNOTATION: str(priority),
    }


def gang_job_manifest(gang: str, accelerator: str, namespace: str,
                      priority: int = 0, job_name: str = "",
                      hosts: int = 1) -> Dict[str, Any]:
    """A minimal gang-annotated Indexed Job: completions == parallelism
    == ``hosts``, every card of a host a worker -- the shape lint R07
    demands."""
    layout = topology.get_host(accelerator)
    cards = str(layout.cards_per_host)
    return {
        "apiVersion": "batch/v1", "kind": "Job",
        "metadata": {
            "name": job_name or f"gang-{gang}",
            "namespace": namespace,
            "annotations": gang_annotations(gang, accelerator, priority),
        },
        "spec": {
            "completionMode": "Indexed",
            "completions": hosts,
            "parallelism": hosts,
            "template": {"spec": {
                "restartPolicy": "Never",
                "containers": [{
                    "name": "worker",
                    "image": "gpu-stack/worker:v1",
                    "resources": {
                        "requests": {GPU_RESOURCE: cards},
                        "limits": {GPU_RESOURCE: cards},
                    },
                }],
            }},
        },
    }
