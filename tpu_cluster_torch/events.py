"""Kubernetes Events pipeline: the third observability pillar. The port's
own copy of ``tpu_cluster/events.py``.

Telemetry gives the stack spans (where did the time go) and metrics
(how much of everything happened); nothing answered "what happened to
THIS object" without digging a trace out of a dump. Real operators lean
on the core/v1 Events API for that — controllers post small structured
records (``involvedObject``, ``reason``, ``message``, ``count``) next to
the objects they act on, and ``kubectl describe`` / ``kubectl get
events`` surfaces them. This module is that pipeline for the tpu-stack
controllers, client-go-shaped:

- :class:`EventRecorder` posts v1 ``Event`` objects through an existing
  :class:`tpu_cluster_torch.kubeapply.Client`.
- **Correlation/aggregation** (the client-go ``EventAggregator`` shape):
  repeated emits with the same (involvedObject, reason, message) key
  inside ``window_s`` collapse into ONE stored Event whose ``count`` is
  bumped via merge-PATCH — a 503-burst's retry storm becomes one row
  with ``count=7``, not seven rows spamming etcd.
- **Spam filter** (the client-go ``EventSourceObjectSpamFilter`` shape):
  a token bucket per involved object — ``spam_burst`` events up front,
  refilled at ``spam_refill_per_s`` — drops pathological emit loops
  before they reach the wire (dropped emits are counted, never posted).
- **Fail-open contract** (hard): event emission NEVER blocks the hot
  path on failure handling, never retries past one wire attempt, and
  never raises. A failed Event write bumps
  ``tpuctl_event_emit_failures_total`` and nothing else happens — the
  rollout/controller proceeds as if it had succeeded. Observability
  must not be able to take down the thing it observes.

Trace join: when a :class:`~tpu_cluster_torch.telemetry.Telemetry` is
attached, every posted Event carries the tracer's W3C context in the
``tpu-stack.dev/traceparent`` annotation (the rollout breadcrumb), so
``tpuctl events`` can name the rollout trace that caused each row.

Concurrency: one ``_lock`` guards recorder state (aggregation map, spam
buckets, counters) and is LEAF-ONLY — every wire attempt and telemetry
emission happens OUTSIDE it (the admission/informer lock discipline,
pinned by the lock-order tests). Emission can race from worker
threads; the aggregation decision is made under the lock, the I/O it
chose is performed after.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Set, Tuple

from . import telemetry as _telemetry

# The annotation carrying the emitting process's trace context on each
# Event (the rollout breadcrumb, re-exported so callers need one import).
TRACEPARENT_ANNOTATION = _telemetry.TRACEPARENT_ANNOTATION

# client-go defaults, kept: 10-minute aggregation window; 25-event
# burst per object refilled at one token per 5 minutes.
DEFAULT_WINDOW_S = 600.0
DEFAULT_SPAM_BURST = 25
DEFAULT_SPAM_REFILL_PER_S = 1.0 / 300.0

EVENT_TYPE_NORMAL = "Normal"
EVENT_TYPE_WARNING = "Warning"

# involvedObject identity: (kind, namespace, name)
_ObjKey = Tuple[str, str, str]
# aggregation identity: (kind, namespace, name, reason, message)
_AggKey = Tuple[str, str, str, str, str]


def involved_ref(obj: Mapping[str, Any]) -> Dict[str, Any]:
    """The ``involvedObject`` reference for one manifest/live object:
    apiVersion/kind/namespace/name (+ uid/resourceVersion when the
    object carries them — live objects do, bare intents don't)."""
    meta = obj.get("metadata") or {}
    ref: Dict[str, Any] = {
        "apiVersion": str(obj.get("apiVersion", "")),
        "kind": str(obj.get("kind", "")),
        "namespace": str(meta.get("namespace", "")),
        "name": str(meta.get("name", "")),
    }
    for key in ("uid", "resourceVersion"):
        value = meta.get(key)
        if value:
            ref[key] = str(value)
    return ref


# Plural -> (kind, apiVersion): lets an informer name its collection in
# an Event reference without a live object in hand (the cache may be
# empty exactly when it matters — sync lost), and lets path_ref derive
# an involvedObject for transport-level events that fire outside any
# apply context (a prefetch LIST retrying, a readiness GET storm).
# Mirrors kubeapply._KINDS spellings.
_COLLECTION_KINDS: Dict[str, Tuple[str, str]] = {
    "namespaces": ("Namespace", "v1"),
    "nodes": ("Node", "v1"),
    "pods": ("Pod", "v1"),
    "configmaps": ("ConfigMap", "v1"),
    "secrets": ("Secret", "v1"),
    "services": ("Service", "v1"),
    "serviceaccounts": ("ServiceAccount", "v1"),
    "jobs": ("Job", "batch/v1"),
    "daemonsets": ("DaemonSet", "apps/v1"),
    "deployments": ("Deployment", "apps/v1"),
    "statefulsets": ("StatefulSet", "apps/v1"),
    "clusterroles": ("ClusterRole",
                     "rbac.authorization.k8s.io/v1"),
    "clusterrolebindings": ("ClusterRoleBinding",
                            "rbac.authorization.k8s.io/v1"),
    "roles": ("Role", "rbac.authorization.k8s.io/v1"),
    "rolebindings": ("RoleBinding", "rbac.authorization.k8s.io/v1"),
    "customresourcedefinitions": ("CustomResourceDefinition",
                                  "apiextensions.k8s.io/v1"),
    "tpustackpolicies": ("TpuStackPolicy", "tpu-stack.dev/v1alpha1"),
}


def collection_ref(path: str) -> Dict[str, Any]:
    """A best-effort ``involvedObject`` for a COLLECTION path (the
    informer's relist/sync-lost events have no single object to blame):
    kind from the plural segment, name = the plural, namespace parsed
    from the path when present."""
    clean = path.partition("?")[0].rstrip("/")
    segments = [s for s in clean.split("/") if s]
    plural = segments[-1] if segments else ""
    namespace = ""
    if "namespaces" in segments[:-1]:
        idx = segments.index("namespaces")
        if idx + 1 < len(segments) - 1:
            namespace = segments[idx + 1]
    kind, api_version = _COLLECTION_KINDS.get(plural,
                                              (plural.capitalize(), "v1"))
    return {"apiVersion": api_version, "kind": kind,
            "namespace": namespace, "name": plural}


def path_ref(path: str) -> Optional[Dict[str, Any]]:
    """Best-effort ``involvedObject`` for a bare REST path — object
    (``.../configmaps/name``) or collection (``.../nodes``) — the
    fallback identity for transport-level events that fire with no
    apply context (a prefetch LIST retrying, a readiness GET against a
    shedding apiserver). None for unrecognized paths (no Event beats a
    mislabeled one)."""
    clean = path.partition("?")[0].rstrip("/")
    segments = [s for s in clean.split("/") if s]
    if not segments:
        return None
    if segments[-1] in _COLLECTION_KINDS:
        return collection_ref(clean)
    if len(segments) >= 2 and segments[-2] in _COLLECTION_KINDS:
        kind, api_version = _COLLECTION_KINDS[segments[-2]]
        namespace = ""
        if "namespaces" in segments[:-2]:
            idx = segments.index("namespaces")
            if idx + 1 < len(segments) - 1:
                namespace = segments[idx + 1]
        return {"apiVersion": api_version, "kind": kind,
                "namespace": namespace, "name": segments[-1]}
    return None


def event_namespace(ref: Mapping[str, Any]) -> str:
    """The namespace an Event about ``ref`` must be created in: the
    involved object's own namespace, or ``default`` for cluster-scoped
    objects (the real apiserver's core/v1 Event validation rule, which
    the fake enforces too)."""
    return str(ref.get("namespace") or "") or "default"


def _iso_utc(epoch_s: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(epoch_s))


class _Aggregate:
    """One correlated Event's recorder-side state (all fields owned by
    the recorder's lock)."""

    def __init__(self, name: str, namespace: str, first_mono: float) -> None:
        self.name = name
        self.namespace = namespace
        self.first_mono = first_mono
        self.count = 1


class EventRecorder:
    """Posts correlated, spam-filtered v1 Events through ``client``.

    ``client`` needs the :meth:`tpu_cluster_torch.kubeapply.Client.request_once`
    surface (ONE wire attempt, no retry/budget/hedge machinery — the
    fail-open transport). ``telemetry`` feeds the
    ``tpuctl_events_*`` counter families and stamps each Event with the
    tracer's traceparent annotation; None skips both (emission still
    works, uncounted and uncorrelated).

    ``clock`` is injectable (monotonic seconds) so aggregation-window
    and token-bucket behavior is testable without sleeping.
    """

    def __init__(self, client: Any, component: str = "tpu-stack",
                 telemetry: Optional[_telemetry.Telemetry] = None,
                 window_s: float = DEFAULT_WINDOW_S,
                 spam_burst: int = DEFAULT_SPAM_BURST,
                 spam_refill_per_s: float = DEFAULT_SPAM_REFILL_PER_S,
                 clock: Any = time.monotonic) -> None:
        self.client = client
        self.component = component
        self.telemetry = telemetry
        self.window_s = float(window_s)
        self.spam_burst = max(1, int(spam_burst))
        self.spam_refill_per_s = float(spam_refill_per_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._agg: Dict[_AggKey, _Aggregate] = {}  # guarded-by: _lock
        # token buckets per involved object: (tokens, last refill)
        self._buckets: Dict[_ObjKey, Tuple[float, float]] = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self.emitted = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock
        self.failures = 0  # guarded-by: _lock

    # ---------------------------------------------------------- internals

    # requires: self._lock
    def _sweep_locked(self, now: float) -> None:
        """Drop state that can no longer influence behavior, so a
        long-lived recorder (the admission loop runs for the process
        lifetime with events on by default) stays bounded by its LIVE
        correlation keys, not by every key it ever saw. An aggregate
        past its window would start a fresh Event anyway; a bucket
        whose refilled balance is back at burst is indistinguishable
        from no bucket (re-creation seeds at full burst)."""
        for key in [k for k, a in self._agg.items()
                    if now - a.first_mono > self.window_s]:
            del self._agg[key]
        for okey in [k for k, (tokens, last) in self._buckets.items()
                     if tokens + (now - last) * self.spam_refill_per_s
                     >= self.spam_burst]:
            del self._buckets[okey]

    # requires: self._lock
    def _take_token_locked(self, key: _ObjKey, now: float) -> bool:
        tokens, last = self._buckets.get(key, (float(self.spam_burst), now))
        tokens = min(float(self.spam_burst),
                     tokens + (now - last) * self.spam_refill_per_s)
        if tokens < 1.0:
            self._buckets[key] = (tokens, now)
            return False
        self._buckets[key] = (tokens - 1.0, now)
        return True

    def _count(self, family: str, help_text: str, **labels: str) -> None:
        tel = self.telemetry
        if tel is not None:
            tel.counter(family, help_text, **labels).inc()

    def _annotations(self) -> Dict[str, str]:
        tel = self.telemetry
        if tel is None:
            return {}
        cur = tel.current()
        span_id = (cur.span_id if cur is not None
                   else _telemetry.new_span_id())
        return {TRACEPARENT_ANNOTATION: _telemetry.format_traceparent(
            tel.tracer.trace_id, span_id)}

    def _post(self, agg: _Aggregate, ref: Mapping[str, Any], reason: str,
              message: str, type_: str) -> bool:
        """The initial Event POST — one wire attempt, True when it
        landed (2xx)."""
        now_iso = _iso_utc(time.time())
        event: Dict[str, Any] = {
            "apiVersion": "v1", "kind": "Event",
            "metadata": {"name": agg.name, "namespace": agg.namespace},
            "involvedObject": dict(ref),
            "reason": reason, "message": message, "type": type_,
            "count": 1,
            "firstTimestamp": now_iso, "lastTimestamp": now_iso,
            "source": {"component": self.component},
            "reportingComponent": self.component,
        }
        anns = self._annotations()
        if anns:
            event["metadata"]["annotations"] = anns
        code, _body = self.client.request_once(
            "POST", f"/api/v1/namespaces/{agg.namespace}/events", event)
        return bool(200 <= int(code) < 300)

    def _bump(self, agg: _Aggregate, count: int) -> bool:
        """The aggregation count-bump merge-PATCH — one wire attempt."""
        code, _body = self.client.request_once(
            "PATCH",
            f"/api/v1/namespaces/{agg.namespace}/events/{agg.name}",
            {"count": count, "lastTimestamp": _iso_utc(time.time())},
            "application/merge-patch+json")
        return bool(200 <= int(code) < 300)

    # ----------------------------------------------------------- surface

    def emit(self, involved: Mapping[str, Any], reason: str, message: str,
             type_: str = EVENT_TYPE_NORMAL) -> None:
        """Record one event about ``involved`` (a manifest/live object,
        or an already-built reference dict with apiVersion/kind/
        namespace/name keys). NEVER raises and never retries: the
        fail-open contract (see module docstring)."""
        try:
            self._emit(involved, reason, message, type_)
        except Exception:  # noqa: BLE001 — fail-open is the contract
            with self._lock:
                self.failures += 1
            self._count(_telemetry.EVENT_EMIT_FAILURES_TOTAL,
                        "event writes that failed (fail-open: counted, "
                        "never retried, never raised)")

    def _emit(self, involved: Mapping[str, Any], reason: str,
              message: str, type_: str) -> None:
        ref = (dict(involved) if "metadata" not in involved
               else involved_ref(involved))
        obj_key: _ObjKey = (str(ref.get("kind", "")),
                            str(ref.get("namespace", "")),
                            str(ref.get("name", "")))
        agg_key: _AggKey = obj_key + (reason, message)
        now = float(self._clock())
        namespace = event_namespace(ref)
        # the DECISION happens under the lock; the chosen wire attempt
        # happens after it (leaf-only — the lockorder pin)
        post: Optional[_Aggregate] = None
        bump: Optional[Tuple[_Aggregate, int]] = None
        with self._lock:
            if not self._take_token_locked(obj_key, now):
                self.dropped += 1
                dropped = True
            else:
                dropped = False
                agg = self._agg.get(agg_key)
                if agg is not None \
                        and now - agg.first_mono <= self.window_s:
                    agg.count += 1
                    bump = (agg, agg.count)
                else:
                    # new correlation key: the (rarer) path that grows
                    # state, so it pays for the expired-state sweep
                    self._sweep_locked(now)
                    self._seq += 1
                    name = (f"{(ref.get('name') or 'object')}."
                            f"{self._seq:06d}.{int(now * 1e3) & 0xffffff:06x}")
                    agg = _Aggregate(name, namespace, now)
                    self._agg[agg_key] = agg
                    post = agg
                self.emitted += 1
        if dropped:
            self._count(_telemetry.EVENTS_DROPPED_TOTAL,
                        "emits refused by the per-object token-bucket "
                        "spam filter", reason=reason)
            return
        self._count(_telemetry.EVENTS_EMITTED_TOTAL,
                    "events emitted (new posts and aggregated "
                    "count bumps)", reason=reason)
        ok = (self._post(post, ref, reason, message, type_)
              if post is not None
              else self._bump(bump[0], bump[1]) if bump is not None
              else True)
        if not ok:
            with self._lock:
                if post is not None and self._agg.get(agg_key) is post:
                    # a failed CREATE must not poison the window: no
                    # Event exists on the server to bump, so keeping the
                    # aggregate would 404 every later emit of this key.
                    # Dropping it lets the NEXT emit start a fresh POST
                    # — the failed attempt itself is still never re-sent
                    # (one attempt per emit; a failed count-bump PATCH
                    # keeps the aggregate: the Event DOES exist, and the
                    # next bump carries the cumulative count)
                    del self._agg[agg_key]
                self.failures += 1
            self._count(_telemetry.EVENT_EMIT_FAILURES_TOTAL,
                        "event writes that failed (fail-open: counted, "
                        "never retried, never raised)")

    def counts(self) -> Dict[str, int]:
        """{emitted, dropped, failures} — the recorder's own audit."""
        with self._lock:
            return {"emitted": self.emitted, "dropped": self.dropped,
                    "failures": self.failures}


# --------------------------------------------------------------------------
# Read side (`tpuctl events`): list/stream Events and join each row with
# the rollout trace that caused it.


def fetch_events(client: Any, namespaces: List[str]
                 ) -> List[Dict[str, Any]]:
    """Every Event in ``namespaces`` (absent collections are empty),
    sorted oldest-first by lastTimestamp then name."""
    out: List[Dict[str, Any]] = []
    seen: Set[str] = set()
    for ns in namespaces:
        if ns in seen:
            continue
        seen.add(ns)
        listing = client.list_collection(f"/api/v1/namespaces/{ns}/events")
        out.extend(listing.values())
    out.sort(key=lambda e: (str(e.get("lastTimestamp", "")),
                            str((e.get("metadata") or {}).get("name", ""))))
    return out


def event_matches(event: Mapping[str, Any], target: str) -> bool:
    """``--for`` filter: ``Kind/name`` (case-insensitive kind) or bare
    ``name`` against the event's involvedObject."""
    inv = event.get("involvedObject") or {}
    kind = str(inv.get("kind", ""))
    name = str(inv.get("name", ""))
    if "/" in target:
        want_kind, _, want_name = target.partition("/")
        return (kind.lower() == want_kind.lower()
                and name == want_name)
    return name == target


def _object_path_of_ref(ref: Mapping[str, Any]) -> Optional[str]:
    """Object path for an involvedObject reference, or None for kinds
    the client doesn't model (the trace join is best-effort)."""
    from . import kubeapply
    kind = str(ref.get("kind", ""))
    if kind not in kubeapply._KINDS:
        return None
    obj = {"apiVersion": str(ref.get("apiVersion", "")) or "v1",
           "kind": kind,
           "metadata": {"name": str(ref.get("name", "")),
                        "namespace": str(ref.get("namespace", ""))
                        or "default"}}
    try:
        return kubeapply.object_path(obj)
    except kubeapply.ApplyError:
        return None


def trace_of_event(client: Any, event: Mapping[str, Any],
                   cache: Dict[str, str]) -> str:
    """The trace id correlated with one Event row: the Event's own
    traceparent annotation when the recorder stamped one, else the
    involved object's (the rollout breadcrumb) — fetched once per
    object through ``cache``. '' when nothing correlates."""
    anns = ((event.get("metadata") or {}).get("annotations") or {})
    own = _telemetry.parse_traceparent(
        str(anns.get(TRACEPARENT_ANNOTATION, "")))
    if own is not None:
        return own[0]
    path = _object_path_of_ref(event.get("involvedObject") or {})
    if path is None:
        return ""
    if path not in cache:
        code, live = client.get(path)
        tp = ""
        if code == 200:
            live_anns = ((live.get("metadata") or {})
                         .get("annotations") or {})
            parsed = _telemetry.parse_traceparent(
                str(live_anns.get(TRACEPARENT_ANNOTATION, "")))
            if parsed is not None:
                tp = parsed[0]
        cache[path] = tp
    return cache[path]


def format_event_row(event: Mapping[str, Any], trace_id: str = "") -> str:
    """One `tpuctl events` line: LAST TYPE REASON OBJECT COUNT TRACE
    MESSAGE."""
    inv = event.get("involvedObject") or {}
    obj = f"{inv.get('kind', '?')}/{inv.get('name', '?')}"
    trace = trace_id[:16] if trace_id else "-"
    return (f"{str(event.get('lastTimestamp', '-')):<20}  "
            f"{str(event.get('type', '-')):<7}  "
            f"{str(event.get('reason', '-')):<16}  "
            f"{obj:<40}  "
            f"{int(event.get('count', 1) or 1):>5}  "
            f"{trace:<16}  "
            f"{str(event.get('message', ''))}")


EVENT_HEADER = (f"{'LAST SEEN':<20}  {'TYPE':<7}  {'REASON':<16}  "
                f"{'OBJECT':<40}  {'COUNT':>5}  {'TRACE':<16}  MESSAGE")
