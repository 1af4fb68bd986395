"""Apply manifests against the kube-apiserver and wait for readiness.

The port's own copy of ``tpu_cluster/kubeapply.py``, which holds no
accelerator content: paths, readiness rules, retry taxonomy and the
field managers are the reference's byte for byte, so the native
operator and the reference's tests read the same contract.

The Python half of the rollout machinery: ``python -m tpu_cluster_torch
apply --wait`` uses this for one-shot installs (the ``helm install
--wait`` analog) and the tests drive it against the in-process fake
apiserver. The in-cluster continuous reconciler is the native C++
operator (native/operator/operator_main.cc) — same REST subset, same
readiness rules.

Transports: a base URL (``http://127.0.0.1:8001`` from ``kubectl proxy``, or
the fake apiserver) with optional bearer token / CA file for direct https
apiserver access. By default the client keeps ONE persistent connection per
thread alive across requests (``keep_alive=True``); ``keep_alive=False``
falls back to a fresh urllib socket per request (the pre-pipelining
behavior).

Two rollout strategies share the same group semantics (ordered barriers,
CRD establishment gating, readiness gating):

- sequential (``max_inflight=1``, the default): one object at a time in
  list order, GET-then-POST/PATCH per object — the original apply
  procedure.
- pipelined (``max_inflight>1``): one LIST per collection primes a shared
  live-object cache (skipping the LISTs entirely on a fresh install, probed
  via the bundle's Namespace), objects inside a group apply concurrently in
  dependency tiers, unchanged objects are skipped, and apply responses seed
  readiness.

BOTH strategies wait for readiness through the shared loop in
``wait_ready``: one collection GET per tick fans out to every waiting
object in that collection (this replaced the seed's per-object GET storm
for all callers, so the credential driving ``apply`` needs the ``list``
verb on workload collections, which the rendered RBAC grants).

``wait_ready(watch=True)`` (``tpuctl apply --watch``) upgrades that loop
to streaming watches: ONE ``?watch=1`` stream per collection, started
from the initial LIST's resourceVersion, fans every event out to the
waiting objects — readiness fires on the event, not the next tick, and
the request count is O(streams) instead of O(ticks). Degradation is
explicit: 410 Gone / expired-RV re-LISTs and re-watches; a denied or
failing watch transport falls back to the poll loop above (which itself
degrades to per-object GETs when LIST is denied), so no credential that
converged before can stop converging.

SERVER-SIDE APPLY (KEP-555) is the PRIMARY apply path
(``apply_mode="auto"``, the default): one ``PATCH
application/apply-patch+yaml?fieldManager=tpuctl&force=true`` per object —
no prior GET — with per-field ownership tracked by the apiserver under
this client's field manager (:data:`FIELD_MANAGER`; the in-cluster C++
operator applies under its own, :data:`OPERATOR_FIELD_MANAGER`, so the
two stop overwriting each other's fields). Capability is probed once per
client: a 415/400 answer to an apply patch (an apiserver predating SSA)
flips the sticky ``Client.ssa_supported`` flag and the rollout falls back
to the original GET+merge-PATCH path for good. Because SSA ownership is
exact, the steady-state no-op check is exact too
(:func:`_ssa_is_noop`): a warm re-apply of an unchanged bundle through
the PIPELINED engine (``max_inflight>1``, the engine that holds the
live-object cache the check reads) issues LIST + watch reads only —
zero POST/PATCH mutations — where the merge path's check stayed
conservative; the sequential engine has no cache and re-applies
unconditionally, which SSA at least makes idempotent. The mode actually
used is recorded in the :class:`RolloutJournal`, and ``--resume``
refuses to replay a journal in a different mode (or through a different
backend).

FAILURE TAXONOMY (:class:`RetryPolicy`): every apiserver round trip in
this module converges through one classification — 429/500/502/503/504
and transport status 0 are RETRYABLE (jittered exponential backoff,
honoring ``Retry-After``), 409 Conflict means re-GET-then-re-PATCH (the
apply paths do), every other 4xx is TERMINAL. ``Client._request`` applies
it uniformly, so ``apply_groups``, ``wait_crd_established`` and the
readiness loops inherit it; the watch path retries stream re-opens under
the same classification before degrading to polling. A
:class:`RolloutJournal` (``tpuctl apply --journal/--resume``) makes the
rollout itself restartable: a SIGKILL'd run resumes by re-applying only
the groups that had not converged.

TELEMETRY (``Client.telemetry``, a :class:`tpu_cluster_torch.telemetry.
Telemetry`): when attached (``tpuctl apply --trace-out/--metrics-out``,
the bench), the rollout records a hierarchical span tree — rollout ->
group -> tier -> object -> HTTP wire attempt, with retry/backoff
annotations from the taxonomy above as instant events — plus a metrics
registry: per-verb/status request counters, request-latency and
time-to-ready histograms, retry / skip-unchanged / journal-skip / watch
reconnect counters. One leaf span per WIRE attempt (including the
stale-socket fast retry and watch stream opens), so a clean rollout's
summed http spans equal the apiserver's own request count exactly.
``telemetry=None`` (default) is zero-overhead and behaviorally
identical.

TRACE CORRELATION: with telemetry armed, every wire attempt
carries a W3C ``traceparent`` header whose parent-id IS the attempt's
leaf-span id (generated before the request), so a server recording its
own spans can pair each one with the exact client attempt that caused
it. Mutating applies additionally stamp the object with the
``tpu-stack.dev/traceparent`` annotation (:data:`TRACEPARENT_ANNOTATION`)
— the breadcrumb the C++ operator reads off live objects to attribute
its reconcile slices to the rollout that caused them. The annotation is
per-mutation plumbing, NOT intent: the exact SSA no-op check strips its
field path, so the warm zero-mutation steady state holds with telemetry
on.

DEADLINE DISCIPLINE: the dangerous production failure is the
apiserver that is SLOW, not down — accepts the connection and never
answers (stall), dribbles the body a byte per timeout window (trickle),
cuts a chunked reply mid-stream (truncate), or 200s half-JSON (garbage).
Three layers handle it:

- WHOLE-ATTEMPT WALL: every wire attempt — connect, request, headers,
  full body — is bounded by one wall clock (``Client.timeout`` unless
  ``attempt_deadline_s`` narrows it), the twin of the C++ client's
  ``timeout_ms bounds the WHOLE response`` contract
  (native/operator/kubeclient.cc). The body is drained via bounded
  ``read1`` turns with the wall checked between them, which is what
  defeats a trickle: per-socket-op timeouts alone cannot (every op
  succeeds). Stall/trickle/truncate/garbage all classify into the
  existing transport-0 retry family.
- DEADLINE BUDGET (:class:`DeadlineBudget`, ``tpuctl apply
  --deadline``): one wall budget for the WHOLE rollout, threaded through
  retries (backoff sleeps clamp to the remainder), per-attempt walls,
  CRD-establish and readiness waits, and the kubectl backend's
  subprocess kill timer. Exhaustion raises the typed
  :class:`DeadlineExceeded` carrying the slowest wire attempts from
  telemetry — the triage pointer straight to the slow path.
- HEDGED READS (``Client.hedge_s``, ``tpuctl apply --hedge``): an
  idempotent GET/LIST attempt still unanswered after the hedge
  threshold fires ONE backup attempt on a fresh connection; the first
  response wins and the loser's socket is closed ("The Tail at Scale"
  shape). Counted in ``tpuctl_hedges_total``, marked as a "hedge"
  instant event on the open span (flight-recorder cargo). Mutations are
  never hedged. All three layers default OFF the hot path:
  ``budget=None, hedge_s=None`` is byte-identical request traffic.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import random
import socket
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from types import TracebackType
from typing import (Any, Callable, Dict, FrozenSet, List, Optional,
                    Protocol, Sequence, Set, Tuple)

from . import telemetry as _telemetry

# Shared callable shapes: rollout progress logging, and the kubectl
# runner seam (``(argv, input_text=...) -> (rc, stdout, stderr)``).
LogFn = Callable[[str], None]
KubectlRunner = Callable[..., Tuple[int, str, str]]


class LockLike(Protocol):
    """The mutual-exclusion surface this module's lock parameters
    actually use — the ``with lock:`` context-manager protocol.
    ``threading.Lock``/``RLock`` instances satisfy it structurally, and
    so do the lock-order monitor's tracked proxies
    (the test suite's lock-order monitor), so instrumented tier-1 runs type
    identically. Exists because typeshed < 3.13 models
    ``threading.Lock`` as a FACTORY FUNCTION, so it cannot be used as a
    parameter annotation — an earlier workaround typed these parameters
    ``Any``, which silenced mypy ``--strict`` exactly where lock
    discipline matters most."""

    def __enter__(self) -> bool:
        ...

    def __exit__(self, exc_type: Optional["type[BaseException]"],
                 exc: Optional[BaseException],
                 tb: Optional[TracebackType], /) -> Optional[bool]:
        ...

# kind -> (api prefix builder, plural, cluster-scoped). Mirrors
# native/operator/kubeapi.cc Plurals() — a lookup table so unsupported kinds
# fail loudly instead of 404ing a guessed path.
_KINDS: Dict[str, Tuple[str, bool]] = {
    "Namespace": ("namespaces", True),
    "ConfigMap": ("configmaps", False),
    "Secret": ("secrets", False),
    "Service": ("services", False),
    "ServiceAccount": ("serviceaccounts", False),
    "Pod": ("pods", False),
    "DaemonSet": ("daemonsets", False),
    "Deployment": ("deployments", False),
    "StatefulSet": ("statefulsets", False),
    "Job": ("jobs", False),
    "ClusterRole": ("clusterroles", True),
    "ClusterRoleBinding": ("clusterrolebindings", True),
    "Node": ("nodes", True),
    "Role": ("roles", False),
    "RoleBinding": ("rolebindings", False),
    # the operator's runtime flag surface (ClusterPolicy analog)
    "CustomResourceDefinition": ("customresourcedefinitions", True),
    "TpuStackPolicy": ("tpustackpolicies", True),
}

WORKLOAD_KINDS = ("DaemonSet", "Deployment", "Job")

# Field-manager twin table: the name THIS client applies under, and the
# name the in-cluster C++ operator applies under
# (kubeapi::FieldManager(), native/operator/kubeapi.cc). Distinct on
# purpose — server-side apply tracks per-field ownership per manager, so
# the CLI and the operator co-own the bundle's fields instead of
# force-reverting each other. Pinned as twins by a source-grep of
# kubeapi.cc in the tests and by native/operator/selftest.cc, the
# RetryableStatus/OperandWorkloadKinds pattern.
FIELD_MANAGER = "tpuctl"
OPERATOR_FIELD_MANAGER = "tpu-operator"

# apply_groups rollout strategies for reaching desired state:
#   auto  — server-side apply, falling back to merge for good when the
#           server answers an apply patch with 415/400 (sticky, probed
#           once per client)
#   ssa   — server-side apply required; an unsupported server is an error
#   merge — the original GET+merge-PATCH path, unconditionally
APPLY_MODES = ("auto", "ssa", "merge")


class ApplyError(RuntimeError):
    pass


class SSAUnsupportedError(ApplyError):
    """The apiserver answered an ``application/apply-patch+yaml`` request
    with 415/400 — it predates server-side apply (or rejects the content
    type). The client's ``ssa_supported`` flag is already flipped sticky
    when this raises; ``apply_mode="auto"`` catches it and downgrades the
    rollout to merge-patch, ``apply_mode="ssa"`` surfaces it."""


class DeadlineExceeded(ApplyError):
    """The rollout's wall-clock budget (:class:`DeadlineBudget`,
    ``tpuctl apply --deadline``) ran out. Typed so callers can tell
    "the deadline we asked for expired" from an ordinary apply failure;
    ``slowest_attempts`` carries the telemetry-derived worst wire
    attempts (name, status, duration) — the triage pointer to WHERE the
    time went."""

    def __init__(self, message: str,
                 slowest_attempts: Optional[List[str]] = None) -> None:
        super().__init__(message)
        self.slowest_attempts: List[str] = list(slowest_attempts or [])


class DeadlineBudget:
    """Wall-clock budget for one WHOLE rollout (``tpuctl apply
    --deadline``): armed once, then every layer spends from the same
    remainder — per-attempt walls, retry backoff sleeps, CRD-establish
    and readiness waits, the kubectl backend's subprocess kill timer.
    Read-only after construction (monotonic arithmetic only), so the
    worker pool shares it without a lock."""

    def __init__(self, total_s: float) -> None:
        self.total_s = float(total_s)
        self._t0 = time.monotonic()

    def remaining(self) -> float:
        return self.total_s - (time.monotonic() - self._t0)

    def exhausted(self) -> bool:
        return self.remaining() <= 0.0

    def clamp(self, seconds: float) -> float:
        """``seconds`` capped to the remaining budget (floor 0)."""
        return max(0.0, min(seconds, self.remaining()))


class _AttemptDeadline(Exception):
    """Internal: one wire attempt outlived its whole-attempt wall (the
    transport classifies it as status 0 — the retry family)."""


def _attempt_deadline_error(wall_s: float) -> Dict[str, Any]:
    """Status-0 body for an attempt that outlived its wall — a stalled
    or trickling server. Retryable: the next attempt may land on a
    healthy replica (and the rollout budget bounds how long we try)."""
    return {"message": f"whole-attempt deadline exceeded after "
                       f"{wall_s:.2f}s (stalled or trickling apiserver)",
            "errorClass": "AttemptDeadline"}


def _garbage_error(status: int, payload: bytes) -> Dict[str, Any]:
    """Status-0 body for a 2xx reply whose payload is not JSON — the
    GARBAGE fault class (half-JSON body behind healthy framing).
    Classified into the transport-0 retry family: the object's true
    state is unknown, exactly like a dropped connection."""
    return {"message": f"garbage body on HTTP {status}: not JSON "
                       f"({payload[:80]!r})",
            "errorClass": "GarbageBody"}


class _WatchDenied(Exception):
    """A watch (or its priming LIST) was refused or the transport failed —
    the caller degrades to the poll loop instead of surfacing an error."""

    def __init__(self, code: int, message: Any = "") -> None:
        super().__init__(f"{code} {message}".strip())
        self.code = code


# Statuses a retry can plausibly fix: transport failure (status 0 — refused
# connection, reset, timeout), client-side throttling (429), and the 5xx
# family a flapping apiserver / overloaded proxy emits. Mirrored by the C++
# twin (kubeclient::RetryableStatus, pinned in native/operator/selftest.cc).
RETRYABLE_STATUSES = frozenset({0, 429, 500, 502, 503, 504})

# Exception types that mark a STALE pooled keep-alive socket on a first
# attempt (the server closed an idle connection): retried ONCE on a
# fresh connection immediately, before the RetryPolicy loop is charged.
# One definition shared by the parsed transport (_request_keepalive) and
# the raw scrape transport (get_raw) so the classification cannot drift
# between them.
STALE_SOCKET_EXCEPTIONS: Tuple[type, ...] = (
    http.client.RemoteDisconnected, http.client.BadStatusLine,
    BrokenPipeError, ConnectionResetError)


@dataclass(frozen=True)
class RetryPolicy:
    """One failure taxonomy for every apiserver round trip.

    - ``retryable`` (429/5xx gateway family + transport status 0): jittered
      exponential backoff — ``base_s`` doubling per attempt, clamped to
      ``cap_s`` — honoring a ``Retry-After`` header when the server sent
      one (429/503 throttling), up to ``attempts`` total tries.
    - ``conflict`` (409): not retried blindly; the apply paths resolve it
      semantically (re-GET then re-PATCH — the object exists).
    - ``terminal`` (every other 4xx): retrying cannot help; fail now.
    """

    attempts: int = 5
    base_s: float = 0.1
    cap_s: float = 5.0
    jitter: float = 0.2  # +/- fraction applied to the computed backoff
    retryable: FrozenSet[int] = RETRYABLE_STATUSES

    def classify(self, status: int) -> str:
        """'ok' | 'retryable' | 'conflict' | 'terminal' for one status."""
        if status in self.retryable:
            return "retryable"
        if status == 409:
            return "conflict"
        if 200 <= status < 400:
            return "ok"
        return "terminal"

    def backoff_s(self, attempt: int,
                  retry_after: Optional[float] = None) -> float:
        """Sleep before retry number ``attempt`` (1-based). A server-sent
        Retry-After wins (clamped to ``cap_s`` so a hostile/buggy header
        cannot park the rollout); otherwise exponential from ``base_s``
        with +/-``jitter`` so a fleet retrying the same blip doesn't
        re-synchronize into a thundering herd."""
        delay = min(self.cap_s, self.base_s * (2 ** (max(1, attempt) - 1)))
        delay *= 1 - self.jitter + 2 * self.jitter * random.random()
        if retry_after is not None:
            # the server's delay is a FLOOR, not an appointment: a whole
            # fleet shed at once (APF 429s) that honors the same
            # Retry-After verbatim re-arrives in lockstep and is shed
            # again, forever — never return EARLIER than the server
            # asked, but keep the escalating jittered exponential on
            # top so persistent overload spreads the herd out (pinned
            # by test_fleet's storm-absorption test)
            return max(max(0.0, min(retry_after, self.cap_s)), delay)
        return delay


# Single-try policy: for probes that own their own retry cadence (or tests
# that need the first answer, however bad).
NO_RETRY = RetryPolicy(attempts=1)


def _retry_after_s(value: Optional[str]) -> Optional[float]:
    """Parse a Retry-After header: seconds (integer or fractional — the
    fake apiserver uses fractions to keep tests fast). The http-date form
    is ignored (None -> computed backoff)."""
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None


def _transport_error(exc: BaseException) -> Dict[str, Any]:
    """Status-0 error body that PRESERVES the exception class and errno —
    'connection refused for 300s' must be distinguishable from a TLS
    handshake failure in wait_ready/apply timeout messages."""
    cause = exc
    reason = getattr(exc, "reason", None)  # URLError wraps the real error
    if isinstance(reason, BaseException):
        cause = reason
    body: Dict[str, Any] = {
        "message": f"transport error: {type(cause).__name__}: {cause}",
        "errorClass": type(cause).__name__,
    }
    errno_ = getattr(cause, "errno", None)
    if errno_ is not None:
        body["errno"] = errno_
    return body


def collection_path(obj: Dict[str, Any]) -> str:
    api_version = obj.get("apiVersion", "")
    kind = obj.get("kind", "")
    if kind not in _KINDS:
        raise ApplyError(f"unsupported kind {kind!r}")
    plural, cluster_scoped = _KINDS[kind]
    prefix = (f"/api/{api_version}" if "/" not in api_version
              else f"/apis/{api_version}")
    if cluster_scoped:
        return f"{prefix}/{plural}"
    ns = obj.get("metadata", {}).get("namespace", "default")
    return f"{prefix}/namespaces/{ns}/{plural}"


def object_path(obj: Dict[str, Any]) -> str:
    name = obj.get("metadata", {}).get("name")
    if not name:
        raise ApplyError("object has no metadata.name")
    return f"{collection_path(obj)}/{name}"


def is_ready(obj: Dict[str, Any],
             allow_empty_daemonsets: bool = False) -> bool:
    """Same readiness rules as kubeapi::IsReady (pinned by test_apply.py).

    Upgrade semantics (kubectl ``rollout status`` parity): when the object
    carries ``metadata.generation``, a status from an older generation must
    not satisfy the gate — on a re-reconcile that PATCHes an existing
    DaemonSet/Deployment the old pods are still Ready, so without the
    ``observedGeneration`` and updated-count checks the stage gate would pass
    before the new pods roll. Objects without generation tracking (hand-made
    fixtures) keep the plain count rules.
    """
    kind = obj.get("kind")
    status = obj.get("status") or {}
    gen = (obj.get("metadata") or {}).get("generation")
    tracked = gen is not None
    if tracked and kind in ("DaemonSet", "Deployment") \
            and status.get("observedGeneration", 0) < gen:
        return False
    if kind == "DaemonSet":
        desired = status.get("desiredNumberScheduled", -1)
        ready = status.get("numberReady", -2)
        if desired == 0 and allow_empty_daemonsets:
            return True
        if tracked and status.get("updatedNumberScheduled", 0) < desired:
            return False
        return desired > 0 and desired == ready
    if kind == "Deployment":
        want = (obj.get("spec") or {}).get("replicas", 1)
        if tracked and status.get("updatedReplicas", 0) < want:
            return False
        return status.get("readyReplicas", 0) >= want
    if kind == "Job":
        want = (obj.get("spec") or {}).get("completions", 1)
        return status.get("succeeded", 0) >= want
    return True


def crd_established(live: Optional[Dict[str, Any]]) -> bool:
    conditions = ((live or {}).get("status") or {}).get("conditions", [])
    return any(c.get("type") == "Established" and c.get("status") == "True"
               for c in conditions)


def _seed_ready(live: Optional[Dict[str, Any]], obj: Dict[str, Any],
                allow_empty_daemonsets: bool) -> bool:
    """is_ready over a live object that may have come from a LIST (where
    real apiservers omit per-item ``kind``) — grafted from the manifest."""
    if live is None:
        return False
    if "kind" not in live:
        live = dict(live, kind=obj.get("kind"))
    return is_ready(live, allow_empty_daemonsets)


def _index_items(listing: Optional[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """{name: item} over a LIST response body (None-tolerant; real
    apiservers omit per-item ``kind``, which _seed_ready grafts back)."""
    out: Dict[str, Dict[str, Any]] = {}
    for item in (listing or {}).get("items") or []:
        name = (item.get("metadata") or {}).get("name")
        if name:
            out[name] = item
    return out


def _merge_patch(target: Any, patch: Any) -> Any:
    """RFC 7386 JSON merge patch (twin of the fake apiserver's, kept here
    so the package never imports from tests/)."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = _merge_patch(out.get(k), v)
    return out


def _patch_is_noop(live: Dict[str, Any], desired: Dict[str, Any]) -> bool:
    """True when merge-patching ``desired`` into ``live`` changes nothing —
    the MERGE-mode re-apply skips the round trip entirely. Real apiservers
    omit per-item ``kind`` / ``apiVersion`` from LIST items while the
    manifest always carries them — grafted onto the live side first so
    that cosmetic gap alone can't turn every steady-state re-apply into a
    PATCH. Merge equality is inherently heuristic (arrays replace
    wholesale, so server-side defaulting inside pod templates defeats it
    on real clusters); it only backs the 415-fallback path now — the
    default SSA mode uses the EXACT ownership-based check
    (:func:`_ssa_is_noop`) instead."""
    grafts = {k: desired[k] for k in ("kind", "apiVersion")
              if k in desired and k not in live}
    if grafts:
        live = dict(live, **grafts)
    return _merge_patch(live, desired) == live


# The annotation carrying an apply's trace context onto the object it
# mutated: the operator reads it off live objects and stamps
# its reconcile slices with the originating trace id. One name, defined
# in telemetry (next to its C++ twin pin) and re-exported here where the
# apply paths stamp it.
TRACEPARENT_ANNOTATION = _telemetry.TRACEPARENT_ANNOTATION


def _strip_tp_fields(fields: Dict[str, Any]) -> Dict[str, Any]:
    """A fieldsV1 ownership descriptor NORMALIZED for the no-op check:
    the traceparent annotation's leaf path removed, and an empty
    ``f:annotations`` dropped outright. The steady-state check must
    compare ownership of the INTENT — the annotation is per-rollout
    plumbing stamped at mutation time, and leaving it in would turn
    every warm re-apply into a PATCH just to refresh a trace id.
    Applied to BOTH sides of the comparison: dropping an empty
    ``f:annotations`` from both makes an intent that declares a bare
    ``annotations: {}`` equivalent to one whose only annotation was the
    stripped traceparent (owning an empty map is owning nothing)."""
    meta = fields.get("f:metadata")
    if not isinstance(meta, dict):
        return fields
    anns = meta.get("f:annotations")
    if not isinstance(anns, dict):
        return fields
    anns = {k: v for k, v in anns.items()
            if k != f"f:{TRACEPARENT_ANNOTATION}"}
    meta = dict(meta)
    if anns:
        meta["f:annotations"] = anns
    else:
        del meta["f:annotations"]
    out = dict(fields)
    out["f:metadata"] = meta
    return out


def _fields_v1(obj: Any) -> Dict[str, Any]:
    """fieldsV1-style ownership descriptor for one applied intent: nested
    ``{"f:<key>": {...}}`` dicts mirroring the object's dict structure,
    with scalars/arrays/nulls as ``{}`` leaves. Arrays are ATOMIC
    (x-kubernetes-list-type: atomic semantics — no ``k:``/``v:`` list-
    member keys), matching how the merge-patch path already treats them.
    Twin of the fake apiserver's ``field_set`` (kept here so the package
    never imports from tests/)."""
    out: Dict[str, Any] = {}
    if not isinstance(obj, dict):
        return out
    for k, v in obj.items():
        out[f"f:{k}"] = _fields_v1(v) if isinstance(v, dict) else {}
    return out


def _ssa_is_noop(live: Optional[Dict[str, Any]], desired: Dict[str, Any],
                 manager: str = FIELD_MANAGER) -> bool:
    """EXACT steady-state check for server-side apply: re-applying
    ``desired`` under ``manager`` is a guaranteed no-op iff (a) the live
    object's managedFields record an Apply entry for ``manager`` owning
    exactly the intent's field set — so no ownership transfer and no
    dropped-field pruning can result — and (b) every intent value already
    matches the live object (apply-merge changes nothing). Server-side
    defaulting cannot defeat it the way it defeats the merge heuristic:
    defaulted SIBLING fields sit at paths the intent never mentions, which
    apply-merge leaves untouched, so only values the manager actually
    owns enter the comparison (an owned atomic array still compares
    wholesale — if something rewrote it, the re-apply correctly PATCHes).
    kind/apiVersion are grafted onto LIST items that omit them, as in
    :func:`_patch_is_noop`.

    FAILS CLOSED on encoding mismatch: a server whose fieldsV1 encoding
    differs from :func:`_fields_v1` (real apiservers use ``k:``/``v:``
    member keys for listType=map lists where we model arrays as atomic
    leaves) never equals the intent's set, so the skip doesn't fire and
    the object is re-applied — idempotent under SSA, just not saved. The
    zero-mutation steady state is pinned against the fake apiserver's
    encoding (the twin of ours)."""
    if live is None:
        return False
    entries = (live.get("metadata") or {}).get("managedFields") or []
    mine = next((e for e in entries
                 if e.get("manager") == manager
                 and e.get("operation") == "Apply"), None)
    if mine is None:
        return False
    # the traceparent annotation is stamped at MUTATION time (telemetry
    # on), so the manager's recorded field set may carry it while the
    # bare intent never does — NORMALIZE both sides (strip the
    # annotation path, drop an empty f:annotations) before comparing,
    # or every warm re-apply would PATCH just to refresh a trace id.
    # The live VALUE comparison below is unaffected: the intent never
    # mentions the annotation, so apply-merge leaves it untouched.
    if _strip_tp_fields(mine.get("fieldsV1") or {}) != \
            _strip_tp_fields(_fields_v1(desired)):
        return False
    grafts = {k: desired[k] for k in ("kind", "apiVersion")
              if k in desired and k not in live}
    if grafts:
        live = dict(live, **grafts)
    return _merge_patch(live, desired) == live


class _EventObjScope:
    """Context manager pushing one object onto the calling thread's
    event-context stack (``Client._local.event_objs``) so transport-
    level Event emissions can name the object being applied. The
    null-scope singleton below keeps the events=None hot path free of
    any per-call allocation or thread-local traffic."""

    __slots__ = ("_local", "_obj")

    def __init__(self, local: Any, obj: Optional[Dict[str, Any]]) -> None:
        self._local = local
        self._obj = obj

    def __enter__(self) -> "_EventObjScope":
        if self._obj is not None:
            stack = getattr(self._local, "event_objs", None)
            if stack is None:
                stack = []
                self._local.event_objs = stack
            stack.append(self._obj)
        return self

    def __exit__(self, *exc: object) -> None:
        if self._obj is not None:
            stack = getattr(self._local, "event_objs", None)
            if stack:
                stack.pop()


_NULL_EVENT_SCOPE = _EventObjScope(None, None)


@dataclass
class Client:
    base_url: str
    token: str = ""
    ca_file: Optional[str] = None
    # Per-socket-op timeout AND (by default) the whole-attempt wall: one
    # wire attempt's BODY is drained under this wall clock whatever the
    # per-op progress — the twin of the C++ client's `timeout_ms bounds
    # the WHOLE response` contract (native/operator/kubeclient.cc), so a
    # server that TRICKLES body bytes (every socket op succeeds) can no
    # longer stall an apply forever. The response-HEADER phase is per-op
    # bounded by default and wall-bounded too once deadline discipline
    # is armed (attempt_deadline_s or budget — see _header_watchdog).
    # Watch STREAMS are exempt: deliberate long reads bounded by their
    # own window.
    timeout: float = 10.0
    # Narrower whole-attempt wall than `timeout` when set (seconds): the
    # per-op timeout stays `timeout`, but the attempt as a whole is cut
    # off here — what the slow-fault bench/soak arm to keep tail
    # attempts bounded. None = the wall IS `timeout`.
    attempt_deadline_s: Optional[float] = None
    # Rollout-wide wall budget (tpuctl apply --deadline): when set, the
    # remaining budget caps every per-attempt wall and backoff sleep,
    # and exhaustion raises the typed DeadlineExceeded. Read-only after
    # construction — shared across the worker pool without a lock.
    budget: Optional[DeadlineBudget] = None
    # Hedge threshold for idempotent reads (seconds): a GET with no body
    # still unanswered after this long fires ONE backup attempt on a
    # fresh connection; first response wins, the loser's socket is
    # closed. None (default) = no hedging — no threads, no extra
    # requests (the zero-overhead contract).
    hedge_s: Optional[float] = None
    # Without a ca_file, https requests FAIL unless this is set: sending a
    # bearer ServiceAccount token over unverified TLS hands cluster-admin-ish
    # credentials to any MITM, so disabling verification must be an explicit
    # opt-in (mirrors the C++ kubeclient and kubectl's flag of the same name).
    insecure_skip_tls_verify: bool = False
    # Persistent per-thread connection reuse. Off = a fresh urllib socket
    # per request (the original transport, the bench's sequential arm).
    keep_alive: bool = True
    # Multiplexed transport: a pool size N routes every
    # non-hedged request through ONE shared asyncio transport holding at
    # most N persistent connections — the socket count becomes O(pool)
    # instead of O(worker threads), and demand beyond the pool queues on
    # it instead of opening sockets. None (default) = the thread
    # transports above, byte-identical (no transport object is even
    # created).
    mux: Optional[int] = None
    # Paginated LIST page size: when set, list_collection and
    # the watch 410-resume re-LIST chase ?limit=/?continue= pages via
    # list_paged, so a 1000-node re-sync never buffers one giant body.
    # None (default) = single unpaginated GET, unchanged.
    list_page_limit: Optional[int] = None
    # The uniform failure taxonomy (None -> the default RetryPolicy):
    # every _request converges through it, so apply/wait/delete inherit
    # retries without per-call plumbing.
    retry: Optional[RetryPolicy] = None
    # Sticky server-side-apply capability, probed once per client by the
    # first apply_ssa: None = unknown, True = the server accepted an
    # apply patch, False = it answered 415/400 (every later SSA attempt
    # short-circuits into SSAUnsupportedError without a round trip).
    # Written by whichever worker thread's request resolves capability,
    # read by all of them — the probe lock (an RLock, so the probing
    # thread that already holds it can record its answer) is the flag's
    # guard, not just the probe's.
    ssa_supported: Optional[bool] = None  # guarded-by: _ssa_probe_lock
    # Unified telemetry (tpu_cluster_torch.telemetry): when set, every wire
    # attempt records a leaf span (cat "http") + per-verb/status counter
    # + latency histogram, retries bump tpuctl_retries_total, the
    # readiness loops feed the time-to-ready histogram, and apply_groups
    # builds the rollout span tree around it. None (default) = zero
    # overhead, identical behavior.
    telemetry: Optional[_telemetry.Telemetry] = None
    # Kubernetes Events pipeline: an
    # tpu_cluster_torch.events.EventRecorder (duck-typed Any — events.py
    # imports this module, not the reverse). When attached, the apply
    # paths record operational Events next to the objects they touch:
    # Retrying / RetryExhausted on the retry taxonomy, DeadlineExceeded
    # on budget exhaustion, HedgeFired on a hedge, WatchResumed on a
    # 410 watch resume. Emission is FAIL-OPEN by the recorder's
    # contract (one wire attempt, never raises, failures counted in
    # tpuctl_event_emit_failures_total) and rides request_once(), so it
    # can never recurse into this client's retry/budget/hedge
    # machinery. None (default) = byte-identical request+mutation
    # multiset (the telemetry=None shape).
    events: Any = None
    _warned_insecure: bool = field(default=False, repr=False, compare=False)
    _local: Any = field(default=None, repr=False, compare=False)
    _conns: Any = field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        self._local = threading.local()  # thread-owned (per-thread conn)
        # every connection ever opened, for close()
        self._conns = []  # guarded-by: _conns_lock
        self._conns_lock = threading.Lock()
        if self.retry is None:
            self.retry = RetryPolicy()
        # Retry accounting (the CLI and bench report it): how many requests
        # were re-sent after a retryable failure, and the freshest
        # transport-level error detail (exception class preserved).
        self._retry_lock = threading.Lock()
        self.retries = 0  # guarded-by: _retry_lock
        self.last_transport_error: Optional[str] = None  # guarded-by: _retry_lock
        # hedged-read accounting (the CLI and bench report it): how many
        # idempotent reads fired a backup attempt past the hedge
        # threshold
        self.hedges = 0  # guarded-by: _retry_lock
        # Serializes the FIRST server-side-apply attempt while
        # ssa_supported is unknown (the once-per-client capability probe)
        # AND guards the sticky flag itself. Reentrant: the probing
        # thread holds it across its round trip and then writes the
        # answer through it.
        self._ssa_probe_lock = threading.RLock()
        # The shared multiplexed transport, created EAGERLY when mux is
        # set (construction is cheap; lazy creation would need a lock in
        # the request hot path). None = feature off, no code-path change.
        self._mux_transport: Any = None
        if self.mux:
            from . import muxhttp
            self._mux_transport = muxhttp.MuxTransport(
                self.base_url, pool_size=int(self.mux),
                timeout=self.timeout, tls_context=self._tls_context())

    # ------------------------------------------------------------ transport

    def _tls_context(self) -> Optional[ssl.SSLContext]:
        if not self.base_url.startswith("https"):
            return None
        if not self.ca_file and not self.insecure_skip_tls_verify:
            raise ApplyError(
                f"refusing unverified https to {self.base_url}: no CA "
                f"file; pass --ca-file or --insecure-skip-tls-verify")
        ctx = ssl.create_default_context(cafile=self.ca_file)
        if not self.ca_file:
            if not self._warned_insecure:
                self._warned_insecure = True
                import sys
                print(f"kubeapply: WARNING: TLS verification DISABLED "
                      f"for {self.base_url} (insecure-skip-tls-verify)",
                      file=sys.stderr)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return ctx

    def _new_connection(self) -> http.client.HTTPConnection:
        """A fresh, UNPOOLED connection (the hedged-read attempts use
        these so the orchestrator holds a close() handle for loser
        cancellation; the pooled per-thread transport wraps this)."""
        url = urllib.parse.urlsplit(self.base_url)
        if url.scheme == "https":
            return http.client.HTTPSConnection(
                url.hostname, url.port or 443, timeout=self.timeout,
                context=self._tls_context())
        return http.client.HTTPConnection(
            url.hostname, url.port or 80, timeout=self.timeout)

    def _connection(self) -> http.client.HTTPConnection:
        """The calling thread's persistent connection (created on demand).
        One per thread, never shared: http.client connections aren't
        thread-safe, and the pipelined worker pool drives one thread each."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            return conn
        conn = self._new_connection()
        self._local.conn = conn
        with self._conns_lock:
            self._conns.append(conn)
        return conn

    def _attempt_wall(self) -> float:
        """The whole-attempt wall for ONE wire attempt: the configured
        attempt deadline (default: ``timeout``), further capped by the
        rollout budget's remainder when one is armed (a rollout 0.3s
        from its deadline must not start a 10s attempt)."""
        wall = (self.attempt_deadline_s
                if self.attempt_deadline_s is not None else self.timeout)
        budget = self.budget
        if budget is not None:
            # floor: exhaustion is raised by the caller, not by handing
            # the socket layer a zero/negative timeout
            wall = min(wall, max(0.05, budget.remaining()))
        return wall

    def _header_watchdog(self, conn: Any, deadline: float,
                         severed: List[bool]
                         ) -> Optional[threading.Timer]:
        """Bound the response-HEADER phase by the attempt wall: a timer
        that severs the connection at the wall, so a server trickling
        HEADER bytes (each recv succeeds — the same per-op blind spot
        as a body trickle, which ``getresponse`` is exposed to) cannot
        hold the attempt past it. shutdown() (not close()) because a
        concurrently-blocked recv is only reliably unblocked by a
        shutdown. ``severed`` is marked BEFORE the shutdown so the
        transport can classify the resulting socket error as a DEADLINE
        hit — without it the sever looks exactly like a stale pooled
        socket and the fast retry would re-send for a second full wall.
        Armed ONLY when deadline discipline was explicitly requested
        (``attempt_deadline_s`` or a budget): a timer thread per request
        is the wrong default cost for the healthy hot path, whose header
        phase stays per-op bounded as before."""
        if self.attempt_deadline_s is None and self.budget is None:
            return None

        def sever() -> None:
            severed.append(True)
            sock = getattr(conn, "sock", None)
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

        timer = threading.Timer(max(0.0, deadline - time.monotonic()),
                                sever)
        timer.daemon = True
        timer.start()
        return timer

    def _perform_attempt(self, conn: Any, method: str, path: str,
                         data: Optional[bytes], content_type: str,
                         wall: float, traceparent: Optional[str]
                         ) -> Tuple[int, bytes, Optional[float]]:
        """ONE wire attempt on ``conn`` under the whole-attempt wall:
        send, header watchdog around ``getresponse`` (the phase where
        the wall cannot be checked between reads), wall-checked body
        drain. Returns ``(status, payload, retry_after_s)``; raises
        :class:`_AttemptDeadline` when the wall cut the attempt
        (including a watchdog sever, which otherwise masquerades as a
        dead socket) and lets transport exceptions propagate for the
        caller's classification — the pooled transport may stale-retry,
        the hedge backup never does. Shared by both so the deadline /
        garbage subtleties cannot drift between them."""
        base_path = urllib.parse.urlsplit(self.base_url).path.rstrip("/")
        t0 = time.monotonic()
        conn.timeout = min(self.timeout, wall)
        if conn.sock is not None:
            conn.sock.settimeout(min(self.timeout, wall))
        conn.request(method, base_path + path, body=data,
                     headers=self._headers(data is not None, content_type,
                                           traceparent=traceparent))
        severed: List[bool] = []
        watchdog = self._header_watchdog(conn, t0 + wall, severed)
        try:
            resp = conn.getresponse()
            payload = self._read_body(resp, conn, t0 + wall)
        except (http.client.HTTPException, OSError):
            if severed:
                raise _AttemptDeadline()
            raise
        finally:
            if watchdog is not None:
                watchdog.cancel()
        return (resp.status, payload,
                _retry_after_s(resp.getheader("Retry-After")))

    @staticmethod
    def _classify_payload(status: int, payload: bytes
                          ) -> Tuple[int, Dict[str, Any], bool]:
        """Parse one reply body: ``(code, parsed, garbage)``. A 2xx
        whose body is not JSON is the GARBAGE fault class — the object's
        true state is unknown, so it classifies into the transport-0
        retry family instead of handing callers the junk; non-2xx error
        bodies keep their status with the raw text as the message."""
        try:
            return status, json.loads(payload or b"{}"), False
        except ValueError:
            if 200 <= status < 300:
                return 0, _garbage_error(status, payload), True
            return (status,
                    {"message": payload.decode(errors="replace")[:200]},
                    False)

    def _read_body(self, resp: Any, conn: Any, deadline: float) -> bytes:
        """Drain one response body under a WALL deadline. ``read1`` caps
        each loop turn at one buffered socket read (itself bounded by the
        per-op timeout), and the wall check BETWEEN turns is what defeats
        a trickling server — per-op timeouts alone cannot, because every
        op succeeds. Raises :class:`_AttemptDeadline` when the wall
        passes mid-body."""
        chunks: List[bytes] = []
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise _AttemptDeadline()
            sock = getattr(conn, "sock", None) if conn is not None else None
            if sock is not None:
                sock.settimeout(min(self.timeout, max(remaining, 0.001)))
            chunk = resp.read1(65536)
            if not chunk:
                # read1 drains the body but (unlike read()) never marks a
                # length-framed response CLOSED at exhaustion — close it
                # here or the keep-alive connection refuses its next
                # request as "previous response still open"
                resp.close()
                return b"".join(chunks)
            chunks.append(chunk)

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close every pooled connection (idempotent)."""
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        if self._mux_transport is not None:
            self._mux_transport.close()

    def reap_other_connections(self) -> None:
        """Close every pooled connection EXCEPT the calling thread's.
        Worker threads die with their executor but their thread-local
        connections would stay open (and strongly referenced here)
        forever; the pipelined engine reaps them as each pool winds down
        so a long-lived Client doesn't leak a socket per worker per
        rollout."""
        mine = getattr(self._local, "conn", None)
        with self._conns_lock:
            stale = [c for c in self._conns if c is not mine]
            self._conns = [c for c in self._conns if c is mine]
        for conn in stale:
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

    def _headers(self, has_body: bool, content_type: str,
                 traceparent: Optional[str] = None) -> Dict[str, str]:
        # User-Agent doubles as the default field-manager name real
        # apiservers record for NON-apply writes (POST/merge-PATCH, the
        # fallback path) — without it the merge fallback's fields would
        # show up in managedFields as "Python-urllib", which the
        # ownership drift check would flag as foreign.
        headers = {"Accept": "application/json",
                   "User-Agent": FIELD_MANAGER}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if has_body:
            headers["Content-Type"] = content_type
        if traceparent:
            headers["traceparent"] = traceparent
        return headers

    def _attempt_context(self) -> Tuple[Optional[str], Optional[str]]:
        """``(span_id, traceparent header)`` for ONE wire attempt, or
        ``(None, None)`` with telemetry off. Each attempt gets its OWN
        span id — generated BEFORE the request so the header can carry
        it, then recorded on the attempt's leaf span — which is what
        makes a server-side span resolvable to the exact attempt that
        caused it (the W3C parent-id contract)."""
        tel = self.telemetry
        if tel is None:
            return None, None
        span_id = _telemetry.new_span_id()
        return span_id, _telemetry.format_traceparent(
            tel.tracer.trace_id, span_id)

    def _note_attempt(self, method: str, path: str, status: int,
                      dt: float, span_id: Optional[str] = None,
                      parent: Optional[_telemetry.Span] = None,
                      **extra: Any) -> None:
        """Record ONE wire attempt in the telemetry (leaf span, cat
        "http", under the calling thread's open span; per-verb/status
        request counter; latency histogram). One note per request that
        actually hit the wire — including the keep-alive stale-socket
        fast retry, watch stream opens, and hedged backup attempts — so
        summed http spans equal the apiserver's audit count on a clean
        run (the pinned trace test; only a request that died before the
        server saw it can diverge, and only under chaos). ``parent``
        pins the span across thread boundaries (the hedge attempts run
        on helper threads with no span stack)."""
        tel = self.telemetry
        if tel is None:
            return
        short = path.partition("?")[0]
        tel.leaf(f"{method} {short}", "http", dt, span_id=span_id,
                 parent=parent, verb=method, status=status, **extra)
        tel.counter(_telemetry.REQUESTS_TOTAL,
                    "apiserver wire attempts by verb and status",
                    verb=method, code=str(status)).inc()
        tel.histogram(_telemetry.REQUEST_SECONDS,
                      "apiserver round-trip latency",
                      verb=method).observe(dt)

    def _request_keepalive(
            self, method: str, path: str, data: Optional[bytes],
            content_type: str,
            conn_holder: Optional[List[Any]] = None
    ) -> Tuple[int, Dict[str, Any], Optional[float]]:
        """One request over the thread's persistent connection, returning
        ``(status, parsed, retry_after_s)``. A stale keep-alive socket
        (server restarted, idle timeout) surfaces as RemoteDisconnected /
        reset on the FIRST attempt only — retried once on a fresh
        connection immediately; every further retry belongs to the
        RetryPolicy loop in ``_request`` (with backoff). The WHOLE
        attempt — send, headers, full body — is bounded by the attempt
        wall (see :meth:`_perform_attempt`); outliving it classifies as
        transport status 0, like the C++ twin's "read timeout".
        ``conn_holder``, when given, always names the attempt's LIVE
        connection (refreshed across the stale retry) — the hedge
        orchestrator's sever handle."""
        wall = self._attempt_wall()
        for attempt in (0, 1):
            conn = self._connection()
            if conn_holder is not None:
                conn_holder[:] = [conn]
            # fresh traceparent per attempt: the stale-socket retry is a
            # DISTINCT wire attempt and must pair with its own server span
            span_id, tp = self._attempt_context()
            t0 = time.monotonic()
            try:
                status, payload, retry_after = self._perform_attempt(
                    conn, method, path, data, content_type, wall, tp)
                code, parsed, garbage = self._classify_payload(status,
                                                               payload)
                if garbage:
                    self._drop_connection()
                    self._note_attempt(method, path, 0,
                                       time.monotonic() - t0,
                                       span_id=span_id, garbage=True)
                    return 0, parsed, None
                self._note_attempt(method, path, status,
                                   time.monotonic() - t0, span_id=span_id)
                return status, parsed, retry_after
            except _AttemptDeadline:
                # the attempt outlived its wall (stall/trickle): the
                # connection is mid-body and unusable — sever it
                self._drop_connection()
                self._note_attempt(method, path, 0, time.monotonic() - t0,
                                   span_id=span_id, deadline=True)
                return 0, _attempt_deadline_error(wall), None
            except (http.client.HTTPException, OSError) as exc:
                self._drop_connection()
                if attempt == 0 and isinstance(exc,
                                               STALE_SOCKET_EXCEPTIONS):
                    # stale pooled socket: one fresh retry — still a wire
                    # attempt the server may have seen (chaos drops reply
                    # with a closed socket AFTER logging the request)
                    self._note_attempt(method, path, 0,
                                       time.monotonic() - t0,
                                       span_id=span_id, stale=True)
                    continue
                self._note_attempt(method, path, 0, time.monotonic() - t0,
                                   span_id=span_id)
                return 0, _transport_error(exc), None
        raise AssertionError("unreachable: both attempts return")

    def _request_mux(
            self, method: str, path: str, data: Optional[bytes],
            content_type: str
    ) -> Tuple[int, Dict[str, Any], Optional[float]]:
        """One request through the shared multiplexed transport
        (``mux=N``): same whole-attempt wall, same status-0
        classification (deadline / stale-with-one-fresh-retry / garbage
        / transport) as the keep-alive path, but the socket underneath
        comes from the bounded shared pool instead of this thread."""
        from . import muxhttp
        transport = self._mux_transport
        assert transport is not None
        wall = self._attempt_wall()
        for attempt in (0, 1):
            span_id, tp = self._attempt_context()
            t0 = time.monotonic()
            try:
                status, rheaders, payload = transport.request(
                    method, path,
                    self._headers(data is not None, content_type,
                                  traceparent=tp), data, wall)
            except muxhttp.MuxDeadline:
                self._note_attempt(method, path, 0,
                                   time.monotonic() - t0, span_id=span_id,
                                   deadline=True, mux=True)
                return 0, _attempt_deadline_error(wall), None
            except muxhttp.MuxStale as exc:
                self._note_attempt(method, path, 0,
                                   time.monotonic() - t0, span_id=span_id,
                                   stale=True, mux=True)
                if attempt == 0:
                    # idle pooled conn the server closed: one immediate
                    # fresh attempt, like the keep-alive stale retry
                    continue
                return 0, _transport_error(exc.cause), None
            except muxhttp.MuxError as exc:
                self._note_attempt(method, path, 0,
                                   time.monotonic() - t0, span_id=span_id,
                                   mux=True)
                return 0, _transport_error(exc.cause), None
            code, parsed, garbage = self._classify_payload(status, payload)
            if garbage:
                self._note_attempt(method, path, 0,
                                   time.monotonic() - t0, span_id=span_id,
                                   garbage=True, mux=True)
                return 0, parsed, None
            self._note_attempt(method, path, code, time.monotonic() - t0,
                               span_id=span_id, mux=True)
            return code, parsed, _retry_after_s(
                rheaders.get("retry-after"))
        raise AssertionError("unreachable: both attempts return")

    def _request_oneshot(
            self, method: str, path: str, data: Optional[bytes],
            content_type: str
    ) -> Tuple[int, Dict[str, Any], Optional[float]]:
        span_id, tp = self._attempt_context()
        t0 = time.monotonic()
        code, parsed, retry_after = self._request_oneshot_raw(
            method, path, data, content_type, traceparent=tp)
        self._note_attempt(method, path, code, time.monotonic() - t0,
                           span_id=span_id)
        return code, parsed, retry_after

    def _request_oneshot_raw(
            self, method: str, path: str, data: Optional[bytes],
            content_type: str, traceparent: Optional[str] = None
    ) -> Tuple[int, Dict[str, Any], Optional[float]]:
        req = urllib.request.Request(self.base_url + path, method=method)
        for k, v in self._headers(data is not None, content_type,
                                  traceparent=traceparent).items():
            req.add_header(k, v)
        ctx = self._tls_context()
        wall = self._attempt_wall()
        deadline = time.monotonic() + wall
        try:
            with urllib.request.urlopen(req, data=data,
                                        timeout=min(self.timeout, wall),
                                        context=ctx) as resp:
                # same whole-attempt wall as the keep-alive transport:
                # the body is drained in bounded read1 turns (urllib
                # hides the socket, so the per-op timeout stays fixed —
                # worst case one extra op of grace past the wall)
                payload = self._read_body(resp, None, deadline)
                status = resp.status
                retry_after = _retry_after_s(
                    resp.headers.get("Retry-After"))
            try:
                parsed = json.loads(payload or b"{}")
            except ValueError:
                if 200 <= status < 300:
                    return 0, _garbage_error(status, payload), None
                parsed = {"message": payload.decode(errors="replace")[:200]}
            return status, parsed, retry_after
        except _AttemptDeadline:
            return 0, _attempt_deadline_error(wall), None
        except urllib.error.HTTPError as exc:
            # the ERROR body rides the same wall as a success body — a
            # trickled 500 payload is still the trickle fault class
            try:
                fp = exc.fp
                if fp is not None and hasattr(fp, "read1"):
                    payload = self._read_body(fp, None, deadline)
                else:
                    payload = exc.read()
            except _AttemptDeadline:
                return 0, _attempt_deadline_error(wall), None
            except (http.client.HTTPException, OSError):
                payload = b""
            try:
                parsed = json.loads(payload or b"{}")
            except ValueError:
                parsed = {"message": payload.decode(errors="replace")[:200]}
            retry_after = _retry_after_s(
                exc.headers.get("Retry-After") if exc.headers else None)
            return exc.code, parsed, retry_after
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            # Transport failure (refused/reset/DNS/TLS/timeout): status 0,
            # like the C++ twin's Response.error — the retry loop backs
            # off on it, apply() turns a terminal one into an ApplyError.
            return 0, _transport_error(exc), None

    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None,
                 content_type: str = "application/json"
                 ) -> Tuple[int, Dict[str, Any]]:
        """One logical request under the RetryPolicy: retryable statuses
        (429/5xx/transport) are re-sent with jittered exponential backoff,
        honoring Retry-After; the final (or first non-retryable) answer is
        returned as ``(status, parsed)``. Safe for POST too: a create whose
        response was lost re-POSTs into 409 AlreadyExists, which the apply
        paths resolve as re-GET-then-re-PATCH.

        With a rollout budget armed, every backoff sleep clamps to the
        remainder and an exhausted budget raises the typed
        :class:`DeadlineExceeded` instead of starting another attempt.
        With hedging armed, idempotent reads (GET, no body) route
        through :meth:`_request_hedged`."""
        data = json.dumps(body).encode() if body is not None else None
        policy = self.retry or NO_RETRY
        budget = self.budget
        attempt = 0
        saw_429 = False
        while True:
            attempt += 1
            if budget is not None and budget.exhausted():
                raise self._deadline_error(f"{method} {path}")
            if self.hedge_s is not None and method == "GET" \
                    and data is None and not saw_429:
                code, parsed, retry_after = self._request_hedged(
                    method, path)
            elif self._mux_transport is not None:
                code, parsed, retry_after = self._request_mux(
                    method, path, data, content_type)
            elif self.keep_alive:
                code, parsed, retry_after = self._request_keepalive(
                    method, path, data, content_type)
            else:
                code, parsed, retry_after = self._request_oneshot(
                    method, path, data, content_type)
            if code == 429:
                # APF-style load shedding: the retry of a throttled read
                # must NEVER hedge — a backup attempt against a server
                # that just said "too much in flight" amplifies exactly
                # the storm it is shedding (pinned by test_fleet's
                # never-hedge-a-429 test)
                saw_429 = True
            if code not in policy.retryable or attempt >= policy.attempts:
                if code in policy.retryable:
                    # the retry budget ran out on a still-retryable
                    # answer — the Event the operator greps for when an
                    # apply gave up
                    self._emit_event(
                        "Warning", "RetryExhausted",
                        f"{method} {path.partition('?')[0]} still "
                        f"failing ({code}) after {attempt} attempt(s)",
                        path=path)
                return code, parsed
            with self._retry_lock:
                self.retries += 1
                if code == 0:
                    self.last_transport_error = (parsed or {}).get("message")
            backoff = policy.backoff_s(attempt, retry_after)
            if budget is not None:
                backoff = budget.clamp(backoff)
            if self.telemetry is not None:
                # the retry taxonomy, annotated: which status triggered the
                # retry, which attempt this was, how long we back off —
                # an instant event on the innermost open span so chaos is
                # readable straight off the trace
                self.telemetry.counter(
                    _telemetry.RETRIES_TOTAL,
                    "requests re-sent after a retryable failure",
                    code=str(code)).inc()
                self.telemetry.event(
                    "retry", code=code, attempt=attempt,
                    classification=policy.classify(code),
                    backoff_s=round(backoff, 4))
            # stable message per (object, verb, path, code) so a retry
            # STORM aggregates into one counted Event instead of one
            # row per attempt (the anti-spam soak pin)
            self._emit_event(
                "Warning", "Retrying",
                f"{method} {path.partition('?')[0]} answered {code}; "
                "retrying under backoff", path=path)
            time.sleep(backoff)

    def _deadline_error(self, context: str) -> DeadlineExceeded:
        """The typed budget-exhaustion error, carrying the slowest wire
        attempts from telemetry (when armed) — a DeadlineExceeded that
        cannot say WHERE the wall time went is half a diagnosis."""
        budget = self.budget
        total = budget.total_s if budget is not None else 0.0
        slowest: List[str] = []
        tel = self.telemetry
        if tel is not None:
            events = _telemetry.request_events(tel.chrome_trace())
            events.sort(key=lambda e: -float(e.get("dur", 0.0)))
            slowest = [
                f"{e.get('name', '?')} "
                f"[{e.get('args', {}).get('status', '?')}] "
                f"{float(e.get('dur', 0.0)) / 1e6:.2f}s"
                for e in events[:3]]
        hint = (f"; slowest attempts: {', '.join(slowest)}"
                if slowest else "")
        self._emit_event(
            "Warning", "DeadlineExceeded",
            f"rollout deadline ({total:.1f}s) exhausted during {context}")
        return DeadlineExceeded(
            f"rollout deadline ({total:.1f}s) exhausted during "
            f"{context}{hint}", slowest_attempts=slowest)

    def _hedge_attempt(self, conn: http.client.HTTPConnection,
                       method: str, path: str, wall: float,
                       parent: Optional[_telemetry.Span]
                       ) -> Tuple[int, Dict[str, Any], Optional[float]]:
        """The BACKUP wire attempt of a hedged read, over a dedicated
        connection on the hedge helper thread (``parent`` pins its leaf
        span under the caller's open span — helper threads have no span
        stack). Never raises: every failure classifies as transport
        status 0, exactly like the pooled transport."""
        span_id, tp = self._attempt_context()
        t0 = time.monotonic()
        try:
            status, payload, retry_after = self._perform_attempt(
                conn, method, path, None, "", wall, tp)
            code, parsed, garbage = self._classify_payload(status, payload)
            if garbage:
                self._note_attempt(method, path, 0,
                                   time.monotonic() - t0,
                                   span_id=span_id, parent=parent,
                                   garbage=True, hedge="backup")
                return 0, parsed, None
            self._note_attempt(method, path, status,
                               time.monotonic() - t0, span_id=span_id,
                               parent=parent, hedge="backup")
            return status, parsed, retry_after
        except _AttemptDeadline:
            self._note_attempt(method, path, 0, time.monotonic() - t0,
                               span_id=span_id, parent=parent,
                               deadline=True, hedge="backup")
            return 0, _attempt_deadline_error(wall), None
        except (http.client.HTTPException, OSError) as exc:
            self._note_attempt(method, path, 0, time.monotonic() - t0,
                               span_id=span_id, parent=parent,
                               hedge="backup")
            return 0, _transport_error(exc), None

    def _request_hedged(self, method: str, path: str
                        ) -> Tuple[int, Dict[str, Any], Optional[float]]:
        """One logical idempotent read with tail-tolerant hedging ("The
        Tail at Scale" shape). The PRIMARY attempt runs in the calling
        thread over the normal pooled transport — against a healthy
        server the armed-but-idle cost is one helper thread parked on an
        Event, no extra socket, no TLS handshake. The helper fires ONE
        backup attempt on a fresh connection if the primary is still
        unanswered past ``hedge_s``; a SUCCESSFUL backup severs the
        primary's socket so the caller stops waiting (a failed backup
        cancels nothing — a transport error must never beat an answer in
        flight). The primary's answer wins whenever it has one; only a
        failed primary falls through to the backup's. Worst case the
        read costs two attempt walls (the severed primary's stale-socket
        fast retry may re-send once); typical hedged latency is the
        backup's round trip. Only reachable for GET-without-body:
        mutations are never hedged (a duplicated in-flight PATCH is not
        idempotent under SSA conflicts)."""
        hedge_s = self.hedge_s
        assert hedge_s is not None and method == "GET"
        tel = self.telemetry
        parent = tel.current() if tel is not None else None
        wall = self._attempt_wall()
        primary_done = threading.Event()
        backup_done = threading.Event()
        fired: List[bool] = []  # appended once if the backup launches
        backup_out: List[Tuple[int, Dict[str, Any], Optional[float]]] = []
        # always the primary's LIVE connection: _request_keepalive
        # refreshes it across its stale-socket fast retry, so a sever
        # hits the socket the caller is actually blocked on (a stale
        # handle captured up front would no-op exactly when it matters)
        primary_conn: List[Any] = []

        def backup() -> None:
            if primary_done.wait(hedge_s):
                return  # answered in time: no hedge, no socket
            fired.append(True)
            with self._retry_lock:
                self.hedges += 1
            if tel is not None:
                tel.counter(_telemetry.HEDGES_TOTAL,
                            "idempotent reads hedged with a backup "
                            "attempt", verb=method).inc()
            if parent is not None:
                # instant event on the CALLER's open span (this thread
                # has no span stack) — flight-recorder cargo, like
                # retries
                parent.event("hedge", path=path.partition("?")[0],
                             threshold_s=hedge_s)
            try:
                conn = self._new_connection()
            except ApplyError as exc:  # TLS config refusal
                backup_out.append((0, _transport_error(exc), None))
                backup_done.set()
                return
            out = self._hedge_attempt(conn, method, path, wall, parent)
            try:
                conn.close()
            except OSError:
                pass
            backup_out.append(out)
            backup_done.set()
            if out[0] != 0 and not primary_done.is_set():
                # the backup ANSWERED while the primary still hangs:
                # sever the primary's socket (shutdown unblocks a
                # concurrently-blocked recv; close does not) so the
                # caller takes this answer now instead of at the wall
                live = primary_conn[-1] if primary_conn else None
                sock = getattr(live, "sock", None)
                if sock is not None:
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        helper = threading.Thread(target=backup, daemon=True)
        helper.start()
        try:
            # even with mux armed, BOTH hedge attempts deliberately
            # bypass the shared pool onto dedicated connections: a
            # hedge exists to race a slow transport, and a backup
            # queued behind the very pool it is hedging around (or a
            # sever that kills a pooled socket other requests share)
            # would defeat it
            if self.keep_alive:
                code, parsed, retry_after = self._request_keepalive(
                    method, path, None, "", conn_holder=primary_conn)
            else:
                code, parsed, retry_after = self._request_oneshot(
                    method, path, None, "")
        finally:
            primary_done.set()
        if fired:
            self._emit_event(
                "Normal", "HedgeFired",
                f"GET {path.partition('?')[0]} hedged with a backup "
                f"attempt past the {hedge_s:.3g}s threshold", path=path)
        if code != 0 or not fired:
            return code, parsed, retry_after
        # the primary failed after a hedge fired: prefer the backup's
        # ANSWER (bounded — the backup's own wall expires it)
        backup_done.wait(wall + self.timeout + 5.0)
        if backup_out and backup_out[0][0] != 0:
            return backup_out[0]
        return code, parsed, retry_after

    def get(self, path: str) -> Tuple[int, Dict[str, Any]]:
        return self._request("GET", path)

    def get_raw(self, path: str) -> Tuple[int, bytes]:
        """ONE logical GET returning ``(status, raw body bytes)`` — no
        JSON parsing, no RetryPolicy loop, no hedging. The scrape
        transport (metricsdb.ScrapeManager): exposition
        bodies are Prometheus text, and a scrape is fail-open by
        contract — a dead target is DATA (``up 0``), not an error — so
        one attempt is the whole budget. Runs over the calling thread's
        pooled keep-alive connection with the same single stale-socket
        fast retry as every other request (an idle scrape interval
        outliving the server's keep-alive timeout must read as a stale
        socket, not a dead target), the whole attempt bounded by the
        whole-attempt wall. Status 0 = transport failure / wall exceeded."""
        wall = self._attempt_wall()
        for attempt in (0, 1):
            conn = self._connection()
            span_id, tp = self._attempt_context()
            t0 = time.monotonic()
            try:
                status, payload, _ra = self._perform_attempt(
                    conn, "GET", path, None, "", wall, tp)
                self._note_attempt("GET", path, status,
                                   time.monotonic() - t0,
                                   span_id=span_id, scrape=True)
                return status, payload
            except _AttemptDeadline:
                self._drop_connection()
                self._note_attempt("GET", path, 0,
                                   time.monotonic() - t0,
                                   span_id=span_id, deadline=True,
                                   scrape=True)
                return 0, b""
            except (http.client.HTTPException, OSError) as exc:
                self._drop_connection()
                if attempt == 0 and isinstance(exc,
                                               STALE_SOCKET_EXCEPTIONS):
                    self._note_attempt("GET", path, 0,
                                       time.monotonic() - t0,
                                       span_id=span_id, stale=True,
                                       scrape=True)
                    continue
                self._note_attempt("GET", path, 0,
                                   time.monotonic() - t0,
                                   span_id=span_id, scrape=True)
                return 0, b""
        raise AssertionError("unreachable: both attempts return")

    def request_once(self, method: str, path: str,
                     body: Optional[Dict[str, Any]] = None,
                     content_type: str = "application/json"
                     ) -> Tuple[int, Dict[str, Any]]:
        """ONE wire attempt — no RetryPolicy loop, no budget-exhaustion
        raise, no hedging. The Events pipeline's fail-open transport
       : an Event write must cost at most one attempt and
        must not recurse into the retry machinery that may itself be
        emitting the event. Uses whichever transport the client is
        configured with (mux / keep-alive / oneshot), so it still
        respects the whole-attempt wall and records telemetry like any
        other attempt."""
        data = json.dumps(body).encode() if body is not None else None
        if self._mux_transport is not None:
            code, parsed, _ra = self._request_mux(method, path, data,
                                                  content_type)
        elif self.keep_alive:
            code, parsed, _ra = self._request_keepalive(method, path,
                                                        data, content_type)
        else:
            code, parsed, _ra = self._request_oneshot(method, path, data,
                                                      content_type)
        return code, parsed

    # ------------------------------------------------------------- events
    #: the apply paths keep a per-thread "current object"
    # stack so transport-level emissions (retry/deadline/hedge live in
    # _request, which never sees the object) can name the object they
    # happened FOR. Zero overhead with events=None: the scope helper
    # returns a shared null scope and no stack is ever created.

    def _event_scope(self, obj: Dict[str, Any]) -> "_EventObjScope":
        if self.events is None:
            return _NULL_EVENT_SCOPE
        return _EventObjScope(self._local, obj)

    def _event_involved(self) -> Optional[Dict[str, Any]]:
        stack = getattr(self._local, "event_objs", None)
        return stack[-1] if stack else None

    def _emit_event(self, type_: str, reason: str, message: str,
                    involved: Optional[Dict[str, Any]] = None,
                    path: Optional[str] = None) -> None:
        """Fail-open event emission about the current (or an explicit)
        involved object. With neither, ``path`` derives a best-effort
        reference (events.path_ref) so transport-level events outside
        any apply context — a prefetch LIST retrying, a readiness GET
        storm — still land next to SOMETHING greppable; with nothing
        nameable at all, silently a no-op."""
        rec = self.events
        if rec is None:
            return
        if involved is None:
            involved = self._event_involved()
        if involved is None and path is not None:
            from . import events as _events
            involved = _events.path_ref(path)
        if involved is None:
            return
        rec.emit(involved, reason, message, type_=type_)

    def list_collection(self, path: str,
                        limit: Optional[int] = None
                        ) -> Dict[str, Dict[str, Any]]:
        """LIST one collection -> {name: live object}. 404 is an EMPTY
        collection, not an error: a CRD-backed collection doesn't exist
        before its CRD is Established, and the pipelined prefetch must
        treat that exactly like 'no CRs yet'. ``limit`` (or the
        client-wide ``list_page_limit``) switches to the paginated
        ``?limit=/?continue=`` chase — same result, bounded bodies."""
        if limit is None:
            limit = self.list_page_limit
        if limit:
            return self.list_paged(path, limit)[0]
        code, resp = self.get(path)
        if code == 404:
            return {}
        if code != 200:
            raise ApplyError(
                f"LIST {path}: {code} {(resp or {}).get('message', resp)}")
        return _index_items(resp)

    def list_paged(self, path: str, limit: int
                   ) -> Tuple[Dict[str, Dict[str, Any]], str, int]:
        """LIST one collection in ``limit``-sized pages, chasing
        ``metadata.continue`` tokens transparently (apiserver chunked-
        LIST semantics): ``({name: obj}, resourceVersion, pages)`` —
        the resourceVersion is the FIRST page's snapshot, exactly where
        a watch resumes from. An EXPIRED continue token mid-chase (410
        Gone, the apiserver compacted past the snapshot) restarts the
        whole chase from a clean first page — never a partial result —
        bounded at two restarts before failing loudly. Every fetched
        page bumps ``tpuctl_list_pages_total{collection=}``."""
        tel = self.telemetry
        restarts = 0
        while True:
            items: Dict[str, Dict[str, Any]] = {}
            rv = ""
            token = ""
            pages = 0
            expired = False
            while True:
                query = f"?limit={int(limit)}"
                if token:
                    query += "&continue=" + urllib.parse.quote(token,
                                                               safe="")
                code, resp = self.get(path + query)
                if code == 404:
                    # absent collection = empty (first page), or the
                    # collection vanished mid-chase: the tail is empty
                    return items, rv, pages
                if code == 410 and token:
                    expired = True
                    break
                if code != 200:
                    raise ApplyError(
                        f"LIST {path}: {code} "
                        f"{(resp or {}).get('message', resp)}")
                pages += 1
                if tel is not None:
                    tel.counter(_telemetry.LIST_PAGES_TOTAL,
                                "paginated LIST pages fetched",
                                collection=path).inc()
                items.update(_index_items(resp))
                meta = (resp or {}).get("metadata") or {}
                rv = str(meta.get("resourceVersion") or rv)
                token = str(meta.get("continue") or "")
                if not token:
                    return items, rv, pages
            assert expired
            restarts += 1
            if restarts > 2:
                raise ApplyError(
                    f"LIST {path}: continue token expired on "
                    f"{restarts} consecutive chases")
            if tel is not None:
                tel.event("list-continue-expired", collection=path)

    def _annotated(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """The object as sent on a MUTATING apply: with telemetry armed,
        a ``tpu-stack.dev/traceparent`` annotation carrying this
        tracer's trace id and the innermost open span (the object-apply
        span) as parent — the breadcrumb the C++ operator reads off live
        objects to attribute its reconcile slices to the rollout that
        caused them. Stamped ONLY on actual mutations (the no-op skip
        checks run against the bare intent first), and not at all with
        telemetry off — zero overhead, byte-identical payloads."""
        tel = self.telemetry
        if tel is None:
            return obj
        meta_in = obj.get("metadata") or {}
        anns_in = meta_in.get("annotations") or {}
        if TRACEPARENT_ANNOTATION in anns_in:
            # the intent DECLARES a trace context (e.g. a manifest
            # exported from a live cluster): the declared value is the
            # intent, and overwriting it would keep live != intent
            # forever — every warm re-apply would mutate just to swap
            # trace ids
            return obj
        cur = tel.current()
        span_id = cur.span_id if cur is not None else _telemetry.new_span_id()
        out = dict(obj)
        meta = dict(meta_in)
        anns = dict(anns_in)
        anns[TRACEPARENT_ANNOTATION] = _telemetry.format_traceparent(
            tel.tracer.trace_id, span_id)
        meta["annotations"] = anns
        out["metadata"] = meta
        return out

    def apply(self, obj: Dict[str, Any]) -> str:
        """Create-or-patch one object; returns 'created' | 'patched'.
        The object is this thread's event context for the duration
        (transport-level Events name the object being applied)."""
        with self._event_scope(obj):
            return self._apply_merge_path(obj)

    def _apply_merge_path(self, obj: Dict[str, Any]) -> str:
        path = object_path(obj)
        obj = self._annotated(obj)
        code, resp = self.get(path)
        if code == 0:
            msg = resp.get("message", "transport failure")
            raise ApplyError(f"GET {path}: {msg}")
        if code == 404:
            code, resp = self._request("POST", collection_path(obj), obj)
            if code == 409:
                # AlreadyExists despite our 404 read: stale-read window
                # after an apiserver bounce/HA failover (or a concurrent
                # creator). The object is there — patch it, don't fail.
                code, resp = self._request("PATCH", path, obj,
                                           "application/merge-patch+json")
                if code != 200:
                    raise ApplyError(
                        f"PATCH after 409 {path}: {code} {resp}")
                return "patched"
            if code not in (200, 201, 202):
                raise ApplyError(f"POST {path}: {code} {resp}")
            return "created"
        if code != 200:
            raise ApplyError(f"GET {path}: {code}")
        code, resp = self._request("PATCH", path, obj,
                                   "application/merge-patch+json")
        if code != 200:
            raise ApplyError(f"PATCH {path}: {code} {resp}")
        return "patched"

    def _apply_ssa_raw(self, obj: Dict[str, Any], force: bool = True,
                       manager: str = FIELD_MANAGER
                       ) -> Tuple[str, Dict[str, Any]]:
        """One server-side apply round trip: ``(action, live object)``.

        A single ``PATCH application/apply-patch+yaml`` with this
        client's field manager — no prior GET; the apiserver resolves
        create-vs-update itself (201 vs 200). ``force=True`` (the rollout
        default — reverting drift in our own operands is the point, like
        the C++ operator's reconcile) takes ownership of conflicting
        fields; ``force=False`` surfaces a 409 naming the competing
        manager, for callers that want conflicts visible. 415/400 flips
        the sticky ``ssa_supported`` flag and raises
        :class:`SSAUnsupportedError` — and capability is probed ONCE per
        client: while the flag is unknown the first caller holds the
        probe lock through its round trip, so a concurrent first tier
        cannot fan N probe requests at an apiserver that will 415 them
        all."""
        with self._event_scope(obj):
            with self._ssa_probe_lock:
                if self.ssa_supported is None:
                    # capability unknown: probe while HOLDING the lock,
                    # so a concurrent first tier serializes on one probe
                    # request
                    return self._apply_ssa_once(obj, force, manager)
            return self._apply_ssa_once(obj, force, manager)

    def _apply_ssa_once(self, obj: Dict[str, Any], force: bool,
                        manager: str) -> Tuple[str, Dict[str, Any]]:
        # one flag read per call; the sticky-True fast path below skips
        # the post-success write so the steady state costs the worker
        # pool two brief uncontended acquisitions, not three
        with self._ssa_probe_lock:
            supported = self.ssa_supported
        if supported is False:
            raise SSAUnsupportedError(
                f"{self.base_url} does not support server-side apply "
                "(previous apply patch answered 415/400)")
        path = (f"{object_path(obj)}?fieldManager={manager}"
                f"&force={'true' if force else 'false'}")
        code, resp = self._request("PATCH", path, self._annotated(obj),
                                   "application/apply-patch+yaml")
        if code in (415, 400):
            # 400 is ambiguous: pre-SSA apiservers answered apply
            # patches 400 (hence it flips the flag, like 415), but a
            # modern server can also 400 a genuinely bad manifest. The
            # conflation is safe: in auto mode the merge fallback
            # re-sends the same object via POST/PATCH, which surfaces
            # the REAL 400 terminally; in strict ssa mode the error
            # below carries the server's message for triage.
            with self._ssa_probe_lock:
                self.ssa_supported = False
            raise SSAUnsupportedError(
                f"PATCH {path}: {code} "
                f"{(resp or {}).get('message', resp)} — server-side "
                "apply unsupported; merge fallback required")
        if code == 409:
            # field conflict (only reachable with force=False): name the
            # competing manager(s) so the operator on call knows WHO to
            # talk to before force-reverting their edit
            causes = ((resp or {}).get("details") or {}).get("causes") or []
            detail = "; ".join(
                f"{c.get('field', '?')}: {c.get('message', '')}"
                for c in causes) or (resp or {}).get("message", str(resp))
            raise ApplyError(
                f"server-side apply conflict on {object_path(obj)} "
                f"(another field manager owns contested fields): {detail}")
        if code not in (200, 201):
            raise ApplyError(f"SSA PATCH {path}: {code} {resp}")
        if supported is not True:
            with self._ssa_probe_lock:
                self.ssa_supported = True
        return ("created" if code == 201 else "patched"), resp

    def apply_ssa(self, obj: Dict[str, Any], force: bool = True,
                  manager: str = FIELD_MANAGER) -> str:
        """Server-side apply one object; returns 'created' | 'patched'."""
        return self._apply_ssa_raw(obj, force, manager)[0]

    def delete(self, path: str) -> Tuple[int, Any]:
        """DELETE one object; (status, parsed body)."""
        return self._request("DELETE", path)

    def patch_merge(self, path: str,
                    patch: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """One RFC 7386 merge-PATCH; (status, parsed body). The small
        targeted-mutation primitive (the admission loop's decision
        annotations ride on it) — full-object intents go through
        apply/apply_ssa instead."""
        return self._request("PATCH", path, patch,
                             "application/merge-patch+json")

    def wait_crd_established(self, name: str, timeout: float,
                             poll: float = 1.0) -> None:
        """Block until a just-applied CRD reports Established — the window
        where the apiserver doesn't yet serve the CRD's endpoints, during
        which creating a CR of that kind 404s. The wait honors the
        rollout budget (it cannot outlive ``--deadline``), and each poll
        sleep clamps to the deadline remainder — a 5s poll interval must
        not overshoot a 0.3s remaining deadline (the ``_poll_ready``
        clamp, applied here too)."""
        path = ("/apis/apiextensions.k8s.io/v1/"
                f"customresourcedefinitions/{name}")
        budget = self.budget
        if budget is not None:
            timeout = min(timeout, max(0.0, budget.remaining()))
        deadline = time.monotonic() + timeout
        last_err: Optional[str] = None
        while True:
            code, live = self.get(path)
            if code == 200 and crd_established(live):
                return
            # keep the freshest FAILING read for the timeout message — "the
            # apiserver kept 503ing" and "the CRD never Established" are
            # different triage paths
            last_err = (None if code == 200 else
                        f"GET -> {code} {(live or {}).get('message', live)}")
            if time.monotonic() >= deadline:
                if budget is not None and budget.exhausted():
                    raise self._deadline_error(f"CRD {name} establishment")
                hint = f" (last error: {last_err})" if last_err else ""
                raise ApplyError(
                    f"timed out waiting for CRD {name} to be "
                    f"Established{hint}")
            time.sleep(min(poll, max(0.0, deadline - time.monotonic())))

    def wait_ready(self, objs: Sequence[Dict[str, Any]], timeout: float,
                   poll: float = 1.0,
                   allow_empty_daemonsets: bool = False,
                   seed: Optional[Dict[str, Dict[str, Any]]] = None,
                   watch: bool = False,
                   stats: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Shared readiness loop. ``seed`` maps ``object_path(obj)`` to the
        freshest known live object (apply responses / the pipelined cache):
        objects already proven ready cost zero additional requests.

        Poll mode (default): ONE collection GET per tick feeds every
        waiting object in that collection (replacing the per-object GET
        storm — with N DaemonSets pending in a namespace, each tick costs
        1 round trip instead of N).

        Watch mode (``watch=True``): one LIST per collection resolves
        already-ready objects and yields the resourceVersion a single
        ``?watch=1`` stream resumes from; readiness then fires on the
        event, costing O(streams) requests however long the wait runs.
        410 Gone re-LISTs and re-watches; a denied/failed watch degrades
        to the poll loop (whose own LIST-denied fallback still applies).

        Returns ``stats`` — ``{"requests": N, "mode": ...}`` — also
        updated in place when the caller passes its own dict (the
        per-phase timing line and bench report it)."""
        if stats is None:
            stats = {}
        stats.setdefault("requests", 0)
        stats["mode"] = "watch" if watch else "poll"
        budget = self.budget
        if budget is not None:
            # the readiness wait spends from the rollout budget like
            # every other phase — it cannot outlive --deadline
            timeout = min(timeout, max(0.0, budget.remaining()))
        started = time.monotonic()
        deadline = started + timeout
        pending = [o for o in objs if o.get("kind") in WORKLOAD_KINDS]
        if seed:
            pending = [o for o in pending
                       if not _seed_ready(seed.get(object_path(o)), o,
                                          allow_empty_daemonsets)]
        if not pending:
            return stats
        lock = threading.Lock()
        if not watch:
            self._poll_ready(pending, deadline, poll,
                             allow_empty_daemonsets, stats, lock,
                             started=started)
            return stats
        by_collection: Dict[str, List[Dict[str, Any]]] = {}
        for obj in pending:
            by_collection.setdefault(collection_path(obj), []).append(obj)
        failures: List[str] = []
        # parent for the per-collection watcher threads' spans: the span
        # open on THIS thread (the ready-wait phase span when called from
        # apply_groups) — thread-local stacks don't cross threads
        tel = self.telemetry
        parent = tel.current() if tel is not None else None

        # typed-exception flag shared with the watcher threads
        deadline_hit: List[DeadlineExceeded] = []  # guarded-by: lock

        def run(coll: str, members: List[Dict[str, Any]],
                drop_conn: bool = False) -> None:
            try:
                with _telemetry.maybe_span(tel, f"watch {coll}", "watch",
                                           parent=parent,
                                           members=len(members)):
                    self._watch_ready_collection(
                        coll, members, deadline, poll,
                        allow_empty_daemonsets, stats, lock,
                        started=started)
            except ApplyError as exc:
                with lock:
                    failures.append(str(exc))
                    if isinstance(exc, DeadlineExceeded):
                        # preserve the type across the thread join: a
                        # budget-killed wait must surface AS the typed
                        # error, not a generic readiness timeout
                        deadline_hit.append(exc)
            finally:
                if drop_conn:
                    # this worker thread is about to die: its thread-local
                    # keep-alive connection (relist/degrade GETs) must not
                    # stay open and referenced in the Client's pool
                    self._drop_connection()

        colls = list(by_collection.items())
        if len(colls) == 1:
            run(*colls[0])
        else:
            # one stream per collection, concurrently: readiness events
            # arrive in any order and every collection must converge
            threads = [threading.Thread(target=run,
                                        args=(coll, members, True),
                                        daemon=True)
                       for coll, members in colls]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if failures:
            if deadline_hit:
                raise DeadlineExceeded(
                    "; ".join(sorted(failures)),
                    slowest_attempts=deadline_hit[0].slowest_attempts)
            raise ApplyError("; ".join(sorted(failures)))
        return stats

    def _observe_ready(self, started: Optional[float]) -> None:
        """Feed the time-to-ready histogram when one waited object
        resolves (``started`` = when the readiness wait began)."""
        tel = self.telemetry
        if tel is None or started is None:
            return
        tel.histogram(_telemetry.READY_SECONDS,
                      "seconds from wait start to object readiness"
                      ).observe(time.monotonic() - started)

    def _poll_ready(self, pending: List[Dict[str, Any]], deadline: float,
                    poll: float, allow_empty_daemonsets: bool,
                    stats: Dict[str, Any],
                    lock: LockLike,  # guards ``stats`` (shared with the
                                     # per-collection watcher threads)
                    started: Optional[float] = None) -> None:
        """The tick loop shared by poll-mode wait_ready and the watch
        mode's per-collection degradation path."""
        def bump(n: int = 1) -> None:
            with lock:
                stats["requests"] += n

        last_list_err: Optional[str] = None
        while pending:
            # Per-tick: the timeout hint must reflect the FINAL tick's LIST
            # state, not a transient failure that later recovered.
            last_list_err = None
            by_collection: Dict[str, List[Dict[str, Any]]] = {}
            for obj in pending:
                by_collection.setdefault(collection_path(obj),
                                         []).append(obj)
            still = []
            for coll, members in by_collection.items():
                bump()
                code, listing = self.get(coll)
                if code in (200, 404):  # 404 = collection empty (see LIST)
                    items = _index_items(listing) if code == 200 else {}
                else:
                    # LIST denied or failing — e.g. RBAC that grants get
                    # but not list, which WAS enough for the per-object
                    # readiness loop this replaced. Fall back to one GET
                    # per member this tick so such credentials still
                    # converge, and remember the error for the timeout
                    # message.
                    last_list_err = (
                        f"LIST {coll}: {code} "
                        f"{(listing or {}).get('message', listing)}")
                    items = {}
                    for obj in members:
                        bump()
                        one_code, live = self.get(object_path(obj))
                        if one_code == 200:
                            items[obj["metadata"]["name"]] = live
                for obj in members:
                    live = items.get(obj["metadata"]["name"])
                    if not _seed_ready(live, obj, allow_empty_daemonsets):
                        still.append(obj)
                    else:
                        self._observe_ready(started)
            pending = still
            if not pending:
                return
            if time.monotonic() >= deadline:
                budget = self.budget
                if budget is not None and budget.exhausted():
                    raise self._deadline_error("readiness wait")
                names = [o["metadata"]["name"] for o in pending]
                hint = (f" (collection reads failing — "
                        f"{last_list_err})" if last_list_err else "")
                raise ApplyError(
                    f"timed out waiting for readiness: {names}{hint}")
            # clamp to the deadline remainder: a long poll interval must
            # not overshoot a short remaining deadline
            time.sleep(min(poll, max(0.0, deadline - time.monotonic())))

    def _open_watch(self, coll: str, resource_version: str,
                    window_s: int) -> Tuple[Any, Any]:
        """Open a streaming ``?watch=1`` GET on a DEDICATED connection
        (the stream monopolizes its socket until the server's
        timeoutSeconds window ends, so it can never share the pooled
        keep-alive transport). Returns ``(conn, resp)`` on 200; raises
        :class:`_WatchDenied` on any other status or transport failure."""
        url = urllib.parse.urlsplit(self.base_url)
        span_id, tp = self._attempt_context()
        t0 = time.monotonic()
        try:
            if url.scheme == "https":
                conn = http.client.HTTPSConnection(
                    url.hostname, url.port or 443,
                    timeout=window_s + max(5.0, self.timeout),
                    context=self._tls_context())
            else:
                conn = http.client.HTTPConnection(
                    url.hostname, url.port or 80,
                    timeout=window_s + max(5.0, self.timeout))
            query = f"?watch=1&timeoutSeconds={window_s}"
            if resource_version:
                query += f"&resourceVersion={resource_version}"
            conn.request("GET", url.path.rstrip("/") + coll + query,
                         headers=self._headers(False, "", traceparent=tp))
            resp = conn.getresponse()
        except (http.client.HTTPException, OSError) as exc:
            self._note_attempt("GET", coll, 0, time.monotonic() - t0,
                               span_id=span_id, watch=True)
            raise _WatchDenied(0, f"transport error: {exc}")
        self._note_attempt("GET", coll, resp.status,
                           time.monotonic() - t0, span_id=span_id,
                           watch=True)
        if resp.status != 200:
            try:
                body = json.loads(resp.read() or b"{}")
            except ValueError:
                body = {}
            conn.close()
            raise _WatchDenied(resp.status,
                               body.get("message", body.get("reason", "")))
        return conn, resp

    def _watch_ready_collection(self, coll: str,
                                members: List[Dict[str, Any]],
                                deadline: float, poll: float,
                                allow_empty_daemonsets: bool,
                                stats: Dict[str, Any],
                                lock: LockLike,  # guards ``stats``
                                started: Optional[float] = None) -> None:
        """Event-driven readiness for one collection: LIST once, then hold
        one watch stream from the LIST's resourceVersion until every
        member is ready. The server's timeoutSeconds window is clamped to
        the remaining deadline, so a silent stream ends exactly when the
        wait would time out anyway."""
        def bump(n: int = 1) -> None:
            with lock:
                stats["requests"] += n

        def degrade(why: str) -> None:
            with lock:
                stats["mode"] = "poll-fallback"
                stats.setdefault("fallbacks", []).append(why)
            if self.telemetry is not None:
                self.telemetry.event("watch-degraded", collection=coll,
                                     why=why)
            self._poll_ready(list(pending.values()), deadline, poll,
                             allow_empty_daemonsets, stats, lock,
                             started=started)

        pending = {o["metadata"]["name"]: o for o in members}

        def relist() -> str:
            """LIST, resolve already-ready members, return the RV the
            watch resumes from ('' when the collection doesn't exist yet
            or the LIST is denied — the latter degrades). With
            ``list_page_limit`` set the LIST is the paginated chase
           : a 410-resume against a fleet-sized collection
            re-syncs page by page instead of buffering one giant body."""
            if self.list_page_limit:
                try:
                    items, rv, pages = self.list_paged(
                        coll, self.list_page_limit)
                except ApplyError as exc:
                    raise _WatchDenied(0, str(exc))
                bump(max(1, pages))
            else:
                bump()
                code, listing = self.get(coll)
                if code == 200:
                    items = _index_items(listing)
                    rv = str((listing.get("metadata") or {})
                             .get("resourceVersion") or "")
                elif code == 404:
                    items, rv = {}, ""
                else:
                    raise _WatchDenied(
                        code, (listing or {}).get("message", listing))
            for name in list(pending):
                if _seed_ready(items.get(name), pending[name],
                               allow_empty_daemonsets):
                    del pending[name]
                    self._observe_ready(started)
            return rv

        try:
            rv = relist()
        except _WatchDenied as exc:
            return degrade(f"LIST {coll}: {exc}")
        policy = self.retry or NO_RETRY
        denials = 0  # consecutive failed stream opens (reset on success)
        opens = 0    # successful stream opens (reopen #2+ = a reconnect)
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            window = max(1, min(300, int(left) + 1))
            try:
                bump()
                opened = time.monotonic()
                conn, resp = self._open_watch(coll, rv, window)
                denials = 0
                opens += 1
                if opens > 1 and self.telemetry is not None:
                    # every stream beyond the first is a RECONNECT (410
                    # re-watch, flapped apiserver, expired window) — the
                    # gauge of watch-path churn the operator mirrors as
                    # tpu_operator_watch_reconnects_total
                    self.telemetry.counter(
                        _telemetry.WATCH_RECONNECTS_TOTAL,
                        "readiness watch streams re-opened after the "
                        "first", collection=coll).inc()
            except _WatchDenied as exc:
                # Same taxonomy as _request: a RETRYABLE refusal (transport
                # down, 429/5xx blip) re-opens the stream with backoff —
                # the poll loop it would degrade to hits the same flaky
                # server anyway. A terminal one (403: no watch verb)
                # degrades immediately: polling there DOES converge.
                denials += 1
                if exc.code in policy.retryable \
                        and denials < policy.attempts:
                    time.sleep(min(policy.backoff_s(denials),
                                   max(0.0,
                                       deadline - time.monotonic())))
                    continue
                return degrade(f"watch {coll}: {exc}")
            fallback = None
            expired = False
            try:
                while pending:
                    if time.monotonic() >= deadline:
                        break
                    try:
                        raw = resp.readline()
                    except (http.client.HTTPException, OSError):
                        break  # stream died; reopen from the last RV
                    if not raw:
                        break  # clean end of the watch window
                    try:
                        ev = json.loads(raw)
                    except ValueError:
                        continue
                    ev_type = ev.get("type")
                    obj = ev.get("object") or {}
                    if ev_type == "ERROR":
                        if obj.get("code") == 410:
                            expired = True  # compacted history: re-LIST
                        else:
                            fallback = f"watch {coll}: ERROR event {obj}"
                        break
                    new_rv = (obj.get("metadata") or {}).get(
                        "resourceVersion")
                    if new_rv:
                        rv = str(new_rv)
                    if ev_type == "DELETED":
                        continue  # still pending; it cannot be ready
                    name = (obj.get("metadata") or {}).get("name")
                    if name in pending and _seed_ready(
                            obj, pending[name], allow_empty_daemonsets):
                        del pending[name]
                        self._observe_ready(started)
            finally:
                conn.close()  # before any fallback holds the wait
            if fallback is not None:
                return degrade(fallback)
            if expired:
                # expired RV: re-LIST for fresh state + a resumable RV,
                # then re-watch on the next loop turn
                if members:
                    # one Event per resume, on the collection's first
                    # waited object (aggregation collapses a flap storm)
                    self._emit_event(
                        "Normal", "WatchResumed",
                        f"watch on {coll} invalidated (410 Gone); "
                        "re-listing and re-watching",
                        involved=members[0])
                try:
                    rv = relist()
                except _WatchDenied as exc:
                    return degrade(f"LIST {coll}: {exc}")
            elif pending and time.monotonic() - opened < 1.0:
                # the stream died almost immediately without resolving
                # anything (server/proxy resetting long GETs): pace the
                # reopen at the poll tick — never a tight request loop
                time.sleep(min(poll, max(0.0, deadline - time.monotonic())))
        if pending:
            budget = self.budget
            if budget is not None and budget.exhausted():
                raise self._deadline_error(f"readiness watch on {coll}")
            names = sorted(pending)
            raise ApplyError(
                f"timed out waiting for readiness: {names} "
                f"(watch on {coll})")


@dataclass
class GroupResult:
    actions: List[str] = field(default_factory=list)
    # Cumulative per-phase wall clock across all groups — the rollout hot
    # path's triage surface (tpuctl apply prints it; bench_rollout.py
    # reports it per arm).
    timings: Dict[str, float] = field(
        default_factory=lambda: {"apply": 0.0, "crd-establish": 0.0,
                                 "ready-wait": 0.0})
    # Readiness request accounting across all groups: how many apiserver
    # round trips the ready-wait phase cost, and which mechanism served it
    # ("watch", "poll", or "poll-fallback" when a watch degraded).
    ready_requests: int = 0
    ready_mode: str = ""
    # The apply mechanism the rollout actually used: "ssa" (server-side
    # apply) or "merge" (GET+merge-PATCH — requested, or the sticky
    # 415/400 fallback). "" on the kubectl backend.
    apply_mode: str = ""

    def timings_line(self) -> str:
        line = ", ".join(f"{k} {v:.2f}s" for k, v in self.timings.items())
        if self.apply_mode:
            line += f" [apply via {self.apply_mode}]"
        if self.ready_mode:
            line += (f" [ready-wait: {self.ready_requests} request(s) "
                     f"via {self.ready_mode}]")
        return line


class RolloutJournal:
    """Durable rollout progress for ``tpuctl apply --journal/--resume``.

    A JSON-lines file: one header record pinning the bundle fingerprint,
    then ``{"group": i, "object": key}`` per applied object (keyed per
    group — the same name may be applied by two groups) and
    ``{"group": i}`` per CONVERGED group (readiness gate passed, not just
    submitted; ``wait=False`` groups are never marked). Every record is
    flushed and fsync'd before the rollout proceeds, so a SIGKILL at any
    instant leaves a journal describing exactly what finished (a torn
    final line from a mid-write kill is dropped, and the file is
    rewritten clean on open). Resuming with the same rendered groups
    skips completed
    groups outright (zero apiserver requests) and already-applied objects
    inside the interrupted group — whose readiness is still re-gated:
    convergence, not bookkeeping, completes a group. A journal whose
    fingerprint doesn't match the groups (the spec changed between runs)
    is discarded and restarted: resuming a different rollout would skip
    work that never happened."""

    def __init__(self, path: str,
                 groups: Sequence[Sequence[Dict[str, Any]]],
                 resume: bool = False) -> None:
        self.path = path
        self.fingerprint = self._fingerprint(groups)
        # Objects are keyed PER GROUP: the same kind/ns/name may
        # legitimately be applied by two groups (bootstrap config early,
        # final config late), and a global key would skip the later one.
        self._objects: Set[Tuple[int, str]] = set()
        self._groups: Set[int] = set()
        # The apply mechanism ("ssa" | "merge" | "kubectl") the journaled
        # rollout ran under, recorded with the first applied object (or
        # at backend entry for kubectl). A --resume must replay through
        # the SAME mechanism: each records fields under a different
        # manager, so switching mid-bundle would silently change the
        # ownership story — both backends refuse a mismatch.
        self.mode: Optional[str] = None
        self.resumed = False
        if resume:
            self._load()
        # Always REWRITE from the parsed state (never append): a SIGKILL
        # mid-append leaves a torn unterminated last line, and appending
        # after it would weld the next record onto it — corrupting every
        # later resume. The journal is small; a clean rewrite is cheap.
        self._f = open(path, "w", encoding="utf-8")
        self._append({"journal": "tpuctl-rollout",
                      "fingerprint": self.fingerprint})
        if self.mode is not None:
            self._append({"apply_mode": self.mode})
        for group, key in sorted(self._objects):
            self._append({"group": group, "object": key})
        for group in sorted(self._groups):
            self._append({"group": group})

    @staticmethod
    def _fingerprint(groups: Sequence[Sequence[Dict[str, Any]]]) -> str:
        blob = json.dumps([list(g) for g in groups], sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    @staticmethod
    def object_key(obj: Dict[str, Any]) -> str:
        meta = obj.get("metadata") or {}
        return (f"{obj.get('kind')}/{meta.get('namespace', '')}/"
                f"{meta.get('name')}")

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                raw = f.read().splitlines()
        except OSError:
            return  # no journal yet: fresh rollout
        records = []
        for line in raw:
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                break  # torn tail from a mid-write kill: keep the prefix
        if not records or records[0].get("fingerprint") != self.fingerprint:
            return  # different bundle (or corrupt header): start fresh
        for rec in records[1:]:
            if "object" in rec:
                self._objects.add((int(rec.get("group", -1)),
                                   rec["object"]))
            elif "group" in rec:
                self._groups.add(int(rec["group"]))
            elif "apply_mode" in rec:
                self.mode = str(rec["apply_mode"])
        self.resumed = True

    def _append(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def set_mode(self, mode: str) -> None:
        """Record the resolved apply mode (first call wins — the mode is
        per-rollout and cannot flip after an object applied under it:
        auto-mode downgrade is sticky and happens before the first
        journaled object)."""
        if self.mode is None and mode:
            self.mode = mode
            self._append({"apply_mode": mode})

    def object_done(self, obj: Dict[str, Any], group: int) -> None:
        entry = (group, self.object_key(obj))
        if entry not in self._objects:
            self._objects.add(entry)
            self._append({"group": group, "object": entry[1]})

    def group_done(self, index: int) -> None:
        if index not in self._groups:
            self._groups.add(index)
            self._append({"group": index})

    def is_object_done(self, obj: Dict[str, Any], group: int) -> bool:
        return (group, self.object_key(obj)) in self._objects

    def is_group_done(self, index: int) -> bool:
        return index in self._groups

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    def __enter__(self) -> "RolloutJournal":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


def kubectl_runner(argv: Sequence[str], input_text: Optional[str] = None,
                   timeout: float = 900) -> Tuple[int, str, str]:
    """Returns ``(rc, stdout, stderr)``. Streams stay separate so JSON output
    can be parsed from stdout alone — kubectl routinely writes deprecation /
    version-skew warnings to stderr, and concatenating them would corrupt
    ``kubectl get -o json`` parses."""
    import subprocess
    try:
        # Always provide stdin (empty when there's no payload): inheriting
        # the caller's tty would hang any kubectl invocation that reads it.
        proc = subprocess.run(list(argv), input=input_text or "",
                              capture_output=True, text=True,
                              timeout=timeout)
    except FileNotFoundError:
        return 127, "", "kubectl not found on PATH"
    except subprocess.TimeoutExpired:
        return 124, "", f"kubectl killed after {timeout:.0f}s"
    return proc.returncode, proc.stdout, proc.stderr


def _kubectl_timeout(stage_timeout: float,
                     budget: Optional[DeadlineBudget]) -> float:
    """The kill timer for ONE kubectl invocation: generous past the
    stage timeout (kubectl runs its own waits inside), but NEVER past
    the rollout budget's remainder — a stalled kubectl (apiserver gone
    quiet under it) must not outlive ``--deadline``. Floor 1s so an
    almost-exhausted budget still launches the process that gets the
    rc=124 verdict instead of hanging on a zero timeout."""
    kill_after = stage_timeout + 120
    if budget is not None:
        kill_after = min(kill_after, max(1.0, budget.remaining()))
    return kill_after


def apply_groups_kubectl(groups: Sequence[Sequence[Dict[str, Any]]],
                         wait: bool = True, stage_timeout: float = 600,
                         runner: Optional[KubectlRunner] = None,
                         allow_empty_daemonsets: bool = False,
                         log: LogFn = lambda msg: None,
                         retry: Optional[RetryPolicy] = None,
                         journal: Optional[RolloutJournal] = None,
                         lint_mode: str = "off",
                         lint_spec: Optional[Any] = None,
                         lint_external: Optional[FrozenSet[str]] = None,
                         budget: Optional[DeadlineBudget] = None
                         ) -> GroupResult:
    """The kubectl-CLI twin of :func:`apply_groups` for hosts where only
    kubectl (not a proxied apiserver URL) is available — the common case on
    the reference guide's control-plane node. Readiness gating uses
    ``kubectl rollout status`` / ``kubectl wait``, then re-checks
    :func:`is_ready` on the live object so the empty-DaemonSet guard (no
    node matched the selector) holds on this path too.

    Shares the rollout failure taxonomy: rc=124 is :func:`kubectl_runner`'s
    killed-after-timeout sentinel — a slow/flapping apiserver, not a
    rejected manifest — so the group apply is RETRYABLE under ``retry``;
    any other nonzero rc is terminal. ``journal`` records converged groups
    (group granularity only: kubectl applies a whole group per
    invocation), so ``--resume`` skips them.

    ``lint_mode``/``lint_spec`` run the same pre-apply static gate as the
    REST path — ``--lint=error`` blocks before the first kubectl
    invocation.

    ``budget`` (``tpuctl apply --deadline``) is the rollout-wide wall
    budget: every kubectl invocation's kill timer clamps to its
    remainder (:func:`_kubectl_timeout` — a stalled kubectl cannot
    outlive the rollout deadline), the rc=124 retry backoff clamps too,
    and exhaustion raises the typed :class:`DeadlineExceeded`."""
    import json as jsonmod

    import yaml

    _lint_gate(groups, lint_mode, lint_spec, log, lint_external)

    if journal is not None and journal.resumed and journal.mode \
            and journal.mode != "kubectl":
        # The journal came from the REST backend, which recorded its
        # apply mechanism (ssa/merge). kubectl client-side apply is a
        # THIRD mechanism with its own field manager — replaying the
        # remaining groups through it would silently change the
        # ownership story mid-bundle, exactly what the REST resume's
        # mode guard refuses. A 'kubectl' journal is OURS and resumes
        # normally.
        raise ApplyError(
            f"--resume: the journal recorded apply mode "
            f"'{journal.mode}' (REST backend); resuming through the "
            "kubectl backend would re-apply under a different "
            "mechanism — pass --apiserver to resume, or drop --resume "
            "to start fresh")
    if journal is not None:
        # Record this backend's mechanism too, so the guard is
        # symmetric: a kubectl-backend journal resumed via --apiserver
        # is refused by _resolve_apply_mode instead of silently
        # re-applying half the bundle under a REST field manager.
        journal.set_mode("kubectl")

    if runner is None:
        def runner(argv: Sequence[str],
                   input_text: Optional[str] = None
                   ) -> Tuple[int, str, str]:
            # the kill timer is computed PER INVOCATION: the remaining
            # rollout budget shrinks as the rollout runs, and the timer
            # must shrink with it (a fixed default would let one stalled
            # kubectl eat the whole deadline)
            return kubectl_runner(argv, input_text,
                                  timeout=_kubectl_timeout(stage_timeout,
                                                           budget))

    retry = retry or RetryPolicy()
    result = GroupResult()
    for i, group in enumerate(groups):
        if journal is not None and journal.is_group_done(i):
            log(f"group {i + 1}/{len(groups)} already complete (journal); "
                "skipping")
            continue
        text = yaml.dump_all(group, sort_keys=False)
        for attempt in range(1, max(1, retry.attempts) + 1):
            rc, out, err = runner(["kubectl", "apply", "-f", "-"], text)
            if rc != 124 or attempt >= retry.attempts:
                break
            if budget is not None and budget.exhausted():
                raise DeadlineExceeded(
                    f"rollout deadline ({budget.total_s:.1f}s) exhausted "
                    f"during kubectl apply (group {i + 1}): the last "
                    f"invocation was killed after its timeout (rc=124)")
            log(f"kubectl apply (group {i + 1}) killed after timeout "
                f"(rc=124) — retryable; attempt "
                f"{attempt}/{retry.attempts - 1}")
            backoff = retry.backoff_s(attempt)
            if budget is not None:
                backoff = budget.clamp(backoff)
            time.sleep(backoff)
        if rc != 0:
            detail = (out + err)[-400:]
            if rc == 124:
                detail += (f" [retryable timeout persisted across "
                           f"{retry.attempts} attempt(s)]")
            raise ApplyError(f"kubectl apply (group {i + 1}): {detail}")
        for obj in group:
            result.actions.append(
                f"applied {obj['kind']}/{obj['metadata']['name']}")
        # CRD establishment gates the next group's CRs even with wait=False
        # (same correctness rule as the REST path).
        for obj in group:
            if obj.get("kind") != "CustomResourceDefinition":
                continue
            name = obj["metadata"]["name"]
            crd_wait = stage_timeout
            if budget is not None:
                crd_wait = min(crd_wait, max(1.0, budget.remaining()))
            rc, out, err = runner(
                ["kubectl", "wait", "--for=condition=established",
                 f"--timeout={max(1, int(crd_wait))}s",
                 f"customresourcedefinition/{name}"])
            if rc != 0:
                if budget is not None and budget.exhausted():
                    # the budget killed the wait, not the CRD: surface
                    # the TYPED error, as every other exhaustion path
                    raise DeadlineExceeded(
                        f"rollout deadline ({budget.total_s:.1f}s) "
                        f"exhausted waiting for CRD {name} to be "
                        "Established (kubectl wait)")
                raise ApplyError(
                    f"CRD {name} not Established: {(out + err)[-400:]}")
        if not wait:
            # not journaled: a group is complete only once its readiness
            # gate passed, and wait=False never gates (re-applying it on
            # resume is idempotent and cheap — one kubectl apply)
            continue
        # stage_timeout bounds the WHOLE group (matching the REST path),
        # clamped to the rollout budget's remainder when one is armed:
        # each sequential gate gets only the remaining budget.
        stage_budget = stage_timeout
        if budget is not None:
            stage_budget = min(stage_budget, max(1.0, budget.remaining()))
        group_deadline = time.monotonic() + stage_budget
        for obj in group:
            kind = obj.get("kind")
            if kind not in WORKLOAD_KINDS:
                continue
            name = obj["metadata"]["name"]
            ns = obj["metadata"].get("namespace", "default")
            remaining = max(1, int(group_deadline - time.monotonic()))
            timeout_arg = f"--timeout={remaining}s"
            if kind == "Job":
                cmd = ["kubectl", "wait", "--for=condition=complete",
                       f"job/{name}", "-n", ns, timeout_arg]
            else:
                cmd = ["kubectl", "rollout", "status",
                       f"{kind.lower()}/{name}", "-n", ns, timeout_arg]
            rc, out, err = runner(cmd)
            if rc != 0:
                if budget is not None and budget.exhausted():
                    raise DeadlineExceeded(
                        f"rollout deadline ({budget.total_s:.1f}s) "
                        f"exhausted during the readiness gate for "
                        f"{kind}/{name} (kubectl)")
                combined = out + err
                reason = ("timed out waiting for readiness"
                          if rc == 124 or "timed out" in combined
                          else "readiness gate failed")
                raise ApplyError(f"{reason}: {kind}/{name}: {combined[-400:]}")
            if kind == "DaemonSet" and not allow_empty_daemonsets:
                # rollout status exits 0 for a DaemonSet with 0 desired
                # pods; re-check with the REST path's rule so a mislabeled
                # cluster can't report silent success. Parse stdout only —
                # kubectl warnings on stderr must not corrupt the JSON.
                rc, out, err = runner(["kubectl", "get", "daemonset", name,
                                       "-n", ns, "-o", "json"])
                try:
                    live = jsonmod.loads(out) if rc == 0 else None
                except ValueError:
                    live = None
                if live is None:
                    # Cannot confirm — failing open here would defeat the
                    # guard in exactly the case it exists for.
                    raise ApplyError(
                        f"readiness gate failed: could not re-check "
                        f"DaemonSet/{name}: {(out + err)[-200:]}")
                if not is_ready(live):
                    desired = (live.get("status") or {}).get(
                        "desiredNumberScheduled", 0)
                    if desired == 0:
                        raise ApplyError(
                            f"readiness gate failed: DaemonSet/{name} has "
                            "no scheduled pods (no node matches its "
                            "selector?); pass --allow-empty-daemonsets to "
                            "accept this")
                    ready = (live.get("status") or {}).get("numberReady", 0)
                    raise ApplyError(
                        f"readiness gate failed: DaemonSet/{name} pods "
                        f"regressed after rollout ({ready}/{desired} ready)")
        if journal is not None:
            journal.group_done(i)
        log(f"group {i + 1}/{len(groups)} ready")
    return result


def delete_groups(client: Client,
                  groups: Sequence[Sequence[Dict[str, Any]]],
                  log: LogFn = lambda msg: None) -> GroupResult:
    """`helm uninstall` analog for the REST backend: delete everything the
    groups render, in REVERSE order (workloads before the RBAC they run
    under, the namespace last). Absent objects are fine — uninstall is
    idempotent."""
    result = GroupResult()
    for group in reversed(list(groups)):
        for obj in reversed(list(group)):
            path = object_path(obj)
            code, resp = client.delete(path)
            name = f"{obj['kind']}/{obj['metadata']['name']}"
            if code in (200, 202):
                result.actions.append(f"deleted {name}")
                log(f"deleted {name}")
            elif code == 404:
                result.actions.append(f"absent {name}")
            elif code == 409:
                # re-run while a previous delete is still in flight: a
                # Terminating namespace answers 409 until its contents are
                # gone — that IS the uninstall proceeding, not a failure
                result.actions.append(f"terminating {name}")
                log(f"terminating {name} (deletion already in progress)")
            else:
                raise ApplyError(f"DELETE {path}: {code} {resp}")
    return result


def _crd_kinds(groups: Sequence[Sequence[Dict[str, Any]]]
               ) -> Set[Tuple[Optional[str], Optional[str]]]:
    """(apiGroup, kind) pairs defined by CRDs inside ``groups`` — the docs
    whose resource type vanishes with the CRD."""
    kinds = set()
    for group in groups:
        for obj in group:
            if obj.get("kind") == "CustomResourceDefinition":
                spec = obj.get("spec") or {}
                kinds.add((spec.get("group"),
                           (spec.get("names") or {}).get("kind")))
    return kinds


def delete_groups_kubectl(groups: Sequence[Sequence[Dict[str, Any]]],
                          runner: Optional[KubectlRunner] = None,
                          log: LogFn = lambda msg: None) -> GroupResult:
    """The kubectl twin of :func:`delete_groups`: one reverse-ordered
    `kubectl delete --ignore-not-found` per group, last group first.

    Custom-resource docs (kinds a CRD in this bundle defines) go in their
    OWN kubectl invocation with RESTMapper no-matches errors tolerated:
    after the CRD is gone — a re-run of `tpuctl delete`, or the CRD's own
    deletion earlier in this reverse pass — `--ignore-not-found` does NOT
    cover "no matches for kind", and uninstall must stay idempotent (the
    REST backend already treats this as absent)."""
    import yaml

    if runner is None:
        def runner(argv: Sequence[str], input_text: Optional[str] = None
                   ) -> Tuple[int, str, str]:
            return kubectl_runner(argv, input_text, timeout=900)

    crd_kinds = _crd_kinds(groups)
    result = GroupResult()
    for group in reversed(list(groups)):
        docs = list(reversed(list(group)))
        crs = [d for d in docs
               if (d.get("apiVersion", "").split("/")[0],
                   d.get("kind")) in crd_kinds]
        rest = [d for d in docs if d not in crs]
        for batch, tolerate_no_match in ((crs, True), (rest, False)):
            if not batch:
                continue
            text = yaml.dump_all(batch, sort_keys=False)
            rc, out, err = runner(
                ["kubectl", "delete", "--ignore-not-found", "-f", "-"], text)
            if rc != 0:
                blob = out + err
                no_match = ("no matches for kind" in blob
                            or "doesn't have a resource type" in blob
                            or "the server doesn't have a resource" in blob)
                if not (tolerate_no_match and no_match):
                    raise ApplyError(f"kubectl delete: {blob[-400:]}")
                for obj in batch:
                    name = f"{obj['kind']}/{obj['metadata']['name']}"
                    result.actions.append(f"absent {name} (CRD gone)")
                    log(f"absent {name} (its CRD is already gone)")
                continue
            for obj in batch:
                name = f"{obj['kind']}/{obj['metadata']['name']}"
                result.actions.append(f"deleted {name}")
                log(f"deleted {name}")
    return result


def _note_ready_stats(result: GroupResult, stats: Dict[str, Any]) -> None:
    """Fold one wait_ready's stats into the rollout result. A degraded
    watch anywhere taints the whole rollout's reported mode — the line is
    a triage surface, and 'watch' must mean watch everywhere."""
    result.ready_requests += stats.get("requests", 0)
    mode = stats.get("mode", "")
    if mode and result.ready_mode != "poll-fallback":
        result.ready_mode = mode


def _journal_skip(tel: Optional[_telemetry.Telemetry], kind: str) -> None:
    """Count work a --resume skipped on journal evidence (kind =
    "group" | "object") — the journal/resume path's telemetry."""
    if tel is not None:
        tel.counter(_telemetry.JOURNAL_SKIPS_TOTAL,
                    "journaled groups/objects skipped on resume",
                    kind=kind).inc()


def _lint_gate(groups: Sequence[Sequence[Dict[str, Any]]],
               lint_mode: str, lint_spec: Optional[Any], log: LogFn,
               lint_external: Optional[FrozenSet[str]] = None) -> None:
    """Run the pre-apply static analysis (tpu_cluster_torch.lint) when a caller
    asked for it. Lazy import: lint imports THIS module for the shared
    tier table, so the dependency must point one way at load time. In
    ``error`` mode a finding raises before the rollout's first request.
    ``lint_external`` extends the pre-existing-on-cluster allowlist
    (``tpuctl apply --allow-external``) so a bundle that passes ``tpuctl
    lint --allow-external X`` passes the gate with the same waiver."""
    if lint_mode and lint_mode != "off":
        from . import lint as lint_static
        external = (lint_static.DEFAULT_EXTERNAL if lint_external is None
                    else lint_external)
        lint_static.gate(groups, lint_mode, spec=lint_spec, log=log,
                         external=external)


class _ModeState:
    """The rollout's resolved apply mechanism, shared across the worker
    pool. The only transition is the one-way sticky downgrade ssa ->
    merge when the server answers the first apply patch with 415/400;
    ``strict`` (apply_mode="ssa", or a journal resumed in ssa) forbids
    even that — the SSAUnsupportedError surfaces instead.

    Shared MUTABLE state: the downgrade is decided on whichever worker
    thread's apply hit the 415 while the rest of the tier reads the mode
    concurrently, so the fields live behind a lock and callers go
    through :meth:`current`/:meth:`downgrade`/:meth:`pop_downgrade`
    (``strict`` is immutable after construction and stays bare)."""

    def __init__(self, mode: str, strict: bool) -> None:
        self._lock = threading.Lock()
        self._mode = mode  # guarded-by: _lock
        self.strict = strict
        self._downgraded: Optional[str] = None  # guarded-by: _lock

    def current(self) -> str:
        with self._lock:
            return self._mode

    def downgrade(self, reason: str) -> None:
        with self._lock:
            self._mode = "merge"
            if self._downgraded is None:
                self._downgraded = reason

    def pop_downgrade(self) -> Optional[str]:
        """The pending downgrade reason, cleared — so the rollout logs
        it exactly once."""
        with self._lock:
            reason, self._downgraded = self._downgraded, None
            return reason


def _resolve_apply_mode(client: Client, apply_mode: str,
                        journal: Optional[RolloutJournal]) -> _ModeState:
    """Pick the rollout's starting mode from the request, the journal
    being resumed, and the client's sticky capability flag. A resumed
    journal's recorded mode WINS (and pins strict): replaying half a
    bundle through the other mechanism would silently change which
    manager owns what."""
    if apply_mode not in APPLY_MODES:
        raise ApplyError(
            f"unknown apply_mode {apply_mode!r}; expected one of "
            f"{'/'.join(APPLY_MODES)}")
    if journal is not None and journal.resumed and journal.mode:
        if journal.mode not in ("ssa", "merge"):
            # recorded by the kubectl backend: client-side apply is a
            # third mechanism with its own field manager — replaying the
            # rest of the bundle via REST would silently change the
            # ownership story mid-bundle (the mirror of the guard in
            # apply_groups_kubectl)
            raise ApplyError(
                f"--resume: the journal recorded apply mode "
                f"'{journal.mode}'; resume it through the same backend "
                "(drop --apiserver), or drop --resume to start fresh")
        if apply_mode != "auto" and apply_mode != journal.mode:
            raise ApplyError(
                f"--resume mode mismatch: the journal recorded apply "
                f"mode '{journal.mode}' but this run requests "
                f"'{apply_mode}'; re-run with --apply-mode="
                f"{journal.mode} (or drop --resume to start fresh)")
        return _ModeState(journal.mode, strict=True)
    if apply_mode == "merge":
        return _ModeState("merge", strict=True)
    if apply_mode == "auto":
        with client._ssa_probe_lock:
            known_unsupported = client.ssa_supported is False
        if known_unsupported:
            return _ModeState("merge", strict=False)
        return _ModeState("ssa", strict=False)
    return _ModeState("ssa", strict=True)  # explicit ssa


def _apply_with_mode(client: Client, obj: Dict[str, Any],
                     state: _ModeState) -> str:
    """One object through the resolved mode: server-side apply, or the
    GET+merge-PATCH path (requested, or the sticky 415/400 fallback)."""
    if state.current() == "ssa":
        try:
            return client.apply_ssa(obj)
        except SSAUnsupportedError as exc:
            if state.strict:
                raise
            state.downgrade(str(exc))
    return client.apply(obj)


def _log_downgrade_once(state: _ModeState,
                        log: Callable[[str], None]) -> None:
    reason = state.pop_downgrade()
    if reason is not None:
        log("server-side apply unavailable; this rollout continues via "
            f"GET+merge-PATCH ({reason})")


def apply_groups(client: Client, groups: Sequence[Sequence[Dict[str, Any]]],
                 wait: bool = True, stage_timeout: float = 600,
                 poll: float = 1.0, allow_empty_daemonsets: bool = False,
                 log: LogFn = lambda msg: None, max_inflight: int = 1,
                 watch_ready: bool = False,
                 journal: Optional[RolloutJournal] = None,
                 lint_mode: str = "off",
                 lint_spec: Optional[Any] = None,
                 lint_external: Optional[FrozenSet[str]] = None,
                 apply_mode: str = "auto") -> GroupResult:
    """Ordered, readiness-gated rollout of manifest groups — the reference's
    operator behavior as a one-shot procedure.

    ``max_inflight > 1`` selects the pipelined engine: shared-cache
    prefetch, tiered concurrent apply inside each group, skip-unchanged
    re-applies, and apply-response-seeded readiness. ``watch_ready``
    selects event-driven readiness (one watch stream per collection; see
    ``Client.wait_ready``). Groups stay ordered barriers in both modes,
    and a failing object in group N always blocks group N+1.

    ``journal`` (``tpuctl apply --journal/--resume``) records progress
    durably: groups it already marks converged are skipped outright, and
    already-applied objects inside the interrupted group are not re-sent —
    a SIGKILL'd rollout restarts idempotently, re-applying only unfinished
    work. Retries against a flaky apiserver come from the Client's
    RetryPolicy — this function never sees a retryable failure.

    ``lint_mode`` (``tpuctl apply --lint=error|warn|off``) runs the static
    bundle analysis (tpu_cluster_torch.lint) BEFORE the first request: ``warn``
    reports findings through ``log`` and proceeds; ``error`` raises
    :class:`tpu_cluster_torch.lint.LintGateError` on any error-severity
    finding, guaranteeing zero requests reach the apiserver. ``lint_spec``
    (the ClusterSpec the bundle was rendered from) enables the
    accelerator-aware checks (R05 alignment); ``lint_external`` extends
    the reference allowlist (``--allow-external``).

    ``apply_mode`` selects the apply mechanism: ``auto`` (default) uses
    server-side apply, downgrading to the merge path for good if the
    server answers 415/400; ``ssa`` requires it; ``merge`` forces the
    original GET+merge-PATCH path. The resolved mode is recorded in the
    journal, and resuming a journal in a different explicit mode is
    refused."""
    _lint_gate(groups, lint_mode, lint_spec, log, lint_external)
    mode_state = _resolve_apply_mode(client, apply_mode, journal)
    result = GroupResult()
    tel = client.telemetry
    engine = "pipelined" if max_inflight > 1 else "sequential"
    with _telemetry.maybe_span(
            tel, "rollout", "rollout", engine=engine, groups=len(groups),
            resumed=bool(journal is not None and journal.resumed)
    ) as rollout_span:
        if max_inflight > 1:
            try:
                return _apply_groups_pipelined(
                    client, groups, wait, stage_timeout, poll,
                    allow_empty_daemonsets, log, max_inflight, result,
                    watch_ready, journal, mode_state)
            finally:
                # the pool's worker threads are gone; their thread-local
                # connections must not outlive them in the Client's pool
                client.reap_other_connections()
                if rollout_span is not None:
                    rollout_span.annotate("apply_mode", mode_state.current())
        for i, group in enumerate(groups):
            if journal is not None and journal.is_group_done(i):
                log(f"group {i + 1}/{len(groups)} already complete "
                    "(journal); skipping")
                _journal_skip(tel, "group")
                continue
            with _telemetry.maybe_span(tel, f"group-{i + 1}", "group",
                                       objects=len(group)):
                t0 = time.monotonic()
                with _telemetry.maybe_span(tel, "apply", "phase"):
                    for obj in group:
                        name = f"{obj['kind']}/{obj['metadata']['name']}"
                        if journal is not None \
                                and journal.is_object_done(obj, i):
                            result.actions.append(f"journaled {name}")
                            log(f"journaled {name} "
                                "(already applied; resume)")
                            _journal_skip(tel, "object")
                            continue
                        with _telemetry.maybe_span(tel, name,
                                                   "apply") as obj_span:
                            action = _apply_with_mode(client, obj,
                                                      mode_state)
                            if obj_span is not None:
                                obj_span.annotate("action", action)
                        _log_downgrade_once(mode_state, log)
                        result.actions.append(f"{action} {name}")
                        log(f"{action} {name}")
                        if journal is not None:
                            journal.set_mode(mode_state.current())
                            journal.object_done(obj, i)
                result.timings["apply"] += time.monotonic() - t0
                # CRD establishment is a correctness gate for the NEXT
                # group's CRs, not a readiness nicety — enforce it even
                # with wait=False.
                t0 = time.monotonic()
                with _telemetry.maybe_span(tel, "crd-establish", "phase"):
                    for obj in group:
                        if obj.get("kind") == "CustomResourceDefinition":
                            client.wait_crd_established(
                                obj["metadata"]["name"], stage_timeout,
                                poll)
                result.timings["crd-establish"] += time.monotonic() - t0
                if wait:
                    t0 = time.monotonic()
                    with _telemetry.maybe_span(tel, "ready-wait", "phase"):
                        stats = client.wait_ready(group, stage_timeout,
                                                  poll,
                                                  allow_empty_daemonsets,
                                                  watch=watch_ready)
                    result.timings["ready-wait"] += time.monotonic() - t0
                    _note_ready_stats(result, stats)
                    log(f"group {i + 1}/{len(groups)} ready")
            if journal is not None and wait:
                # a group is journaled complete only once CONVERGED — with
                # wait=False nothing ever gated readiness, and a later
                # --resume --wait must not skip the gate (the per-object
                # records above still make that resume cheap)
                journal.group_done(i)
        if rollout_span is not None:
            rollout_span.annotate("apply_mode", mode_state.current())
    result.apply_mode = mode_state.current()
    return result


# Objects other tiers depend on apply first even INSIDE a group: a real
# apiserver rejects namespaced objects before their Namespace exists and
# CRs before their CRD — tier barriers keep the pipelined engine safe for
# groups that carry both (the sequential path gets this from list order).
_TIER_FIRST = ("Namespace", "CustomResourceDefinition")


def _group_tiers(group: Sequence[Dict[str, Any]]
                 ) -> List[List[Dict[str, Any]]]:
    """Split one group into dependency tiers whose members may apply
    concurrently: (Namespace/CRD) -> (RBAC/config) -> (workloads)."""
    first = [o for o in group if o.get("kind") in _TIER_FIRST]
    workloads = [o for o in group if o.get("kind") in WORKLOAD_KINDS]
    middle = [o for o in group if o not in first and o not in workloads]
    return [t for t in (first, middle, workloads) if t]


def _apply_one_cached(client: Client, obj: Dict[str, Any],
                      cache: Dict[str, Dict[str, Dict[str, Any]]],
                      cache_lock: LockLike,  # guards ``cache``
                      mode_state: _ModeState,
                      parent_span: Optional[_telemetry.Span] = None) -> str:
    """Span-wrapped :func:`_apply_one_uncounted`: one "apply" span per
    object (parented to the TIER span explicitly — worker-pool threads
    have no inherited span stack), annotated with the action taken, and
    the skip-unchanged / SSA-noop counter."""
    tel = client.telemetry
    name = f"{obj['kind']}/{obj['metadata']['name']}"
    with _telemetry.maybe_span(tel, name, "apply",
                               parent=parent_span) as span:
        with client._event_scope(obj):
            action = _apply_one_uncounted(client, obj, cache, cache_lock,
                                          mode_state)
        if span is not None:
            span.annotate("action", action)
        if action == "unchanged" and tel is not None:
            tel.counter(_telemetry.UNCHANGED_TOTAL,
                        "re-applies skipped as provably no-op "
                        "(ssa = exact managedFields check)",
                        mode=mode_state.current()).inc()
        return action


def _apply_one_uncounted(client: Client, obj: Dict[str, Any],
                         cache: Dict[str, Dict[str, Dict[str, Any]]],
                         cache_lock: LockLike,  # guards ``cache``
                         mode_state: _ModeState) -> str:
    """Apply one object against the shared live-object cache.

    SSA mode: present and provably identical under this manager's
    ownership (:func:`_ssa_is_noop` — the EXACT check) -> skip with zero
    requests; anything else -> one apply PATCH, whatever the server
    holds. Merge mode (requested or the sticky 415/400 fallback): absent
    -> POST (409 -> PATCH, the stale-cache window), present and
    merge-identical -> skip, present and different -> PATCH. Either way
    the response object refreshes the cache so readiness seeding sees
    the newest state."""
    coll = collection_path(obj)
    path = object_path(obj)
    name = obj["metadata"]["name"]
    with cache_lock:
        live = cache.get(coll, {}).get(name)
    if mode_state.current() == "ssa":
        if live is not None and _ssa_is_noop(live, obj):
            return "unchanged"
        try:
            action, resp = client._apply_ssa_raw(obj)
        except SSAUnsupportedError as exc:
            if mode_state.strict:
                raise
            mode_state.downgrade(str(exc))
        else:
            with cache_lock:
                cache.setdefault(coll, {})[name] = resp
            return action
    if live is not None and _patch_is_noop(live, obj):
        return "unchanged"
    if live is None:
        code, resp = client._request("POST", coll, client._annotated(obj))
        if code in (200, 201, 202):
            with cache_lock:
                cache.setdefault(coll, {})[name] = resp
            return "created"
        if code != 409:
            raise ApplyError(f"POST {path}: {code} {resp}")
        # AlreadyExists despite the cache: created outside this rollout
        # (or the fresh-install probe skipped the LIST) — patch it.
    code, resp = client._request("PATCH", path, client._annotated(obj),
                                 "application/merge-patch+json")
    if code != 200:
        raise ApplyError(f"PATCH {path}: {code} {resp}")
    with cache_lock:
        cache.setdefault(coll, {})[name] = resp
    return "patched"


def _apply_groups_pipelined(client: Client,
                            groups: Sequence[Sequence[Dict[str, Any]]],
                            wait: bool, stage_timeout: float, poll: float,
                            allow_empty_daemonsets: bool, log: LogFn,
                            max_inflight: int,
                            result: GroupResult,
                            watch_ready: bool = False,
                            journal: Optional[RolloutJournal] = None,
                            mode_state: Optional[_ModeState] = None
                            ) -> GroupResult:
    """The concurrent engine behind apply_groups(max_inflight>1).

    One LIST per distinct collection primes a shared live-object cache
    (client-go informer shape) — except on a fresh install, detected by
    probing the bundle's first Namespace: when that's absent nothing of
    ours exists, so the prefetch round trips are skipped and stragglers
    are caught by the POST->409->PATCH fallback. Journal-completed groups
    are excluded from the prefetch too — a resume touches only the
    collections the unfinished groups need."""
    from concurrent.futures import ThreadPoolExecutor

    if mode_state is None:
        mode_state = _ModeState("merge", strict=True)
    tel = client.telemetry
    cache: Dict[str, Dict[str, Dict[str, Any]]] = {}
    cache_lock = threading.Lock()
    all_objs = [o for gi, group in enumerate(groups)
                if not (journal is not None and journal.is_group_done(gi))
                for o in group]
    collections: List[str] = []
    for obj in all_objs:
        coll = collection_path(obj)
        if coll not in collections:
            collections.append(coll)

    with ThreadPoolExecutor(max_workers=max_inflight) as pool:
        with _telemetry.maybe_span(tel, "prefetch", "prefetch",
                                   collections=len(collections)
                                   ) as prefetch_span:
            ns_names = [o["metadata"]["name"] for o in all_objs
                        if o.get("kind") == "Namespace"]
            fresh = False
            if ns_names:
                code, live = client.get(
                    f"/api/v1/namespaces/{ns_names[0]}")
                if code == 404:
                    fresh = True
                elif code == 200:
                    cache["/api/v1/namespaces"] = {ns_names[0]: live}
            if prefetch_span is not None:
                prefetch_span.annotate("fresh_install", fresh)
            if fresh:
                for coll in collections:
                    cache.setdefault(coll, {})
            else:
                # worker threads have no span stack: parent the prefetch
                # LIST spans through a thread-boundary wrapper
                def _list(coll: str) -> Dict[str, Dict[str, Any]]:
                    with _telemetry.maybe_span(tel, f"LIST {coll}",
                                               "prefetch",
                                               parent=prefetch_span):
                        return client.list_collection(coll)

                futures = {coll: pool.submit(_list, coll)
                           for coll in collections}
                for coll, fut in futures.items():
                    cache[coll] = {**fut.result(), **cache.get(coll, {})}

        for i, group in enumerate(groups):
            if journal is not None and journal.is_group_done(i):
                log(f"group {i + 1}/{len(groups)} already complete "
                    "(journal); skipping")
                _journal_skip(tel, "group")
                continue
            group_scope = _telemetry.maybe_span(
                tel, f"group-{i + 1}", "group", objects=len(group))
            with group_scope:
                t0 = time.monotonic()
                with _telemetry.maybe_span(tel, "apply", "phase"):
                    for ti, tier in enumerate(_group_tiers(group)):
                        with _telemetry.maybe_span(
                                tel, f"tier-{ti}", "tier",
                                kinds=sorted({o.get("kind", "?")
                                              for o in tier})) as tier_span:
                            todo = []
                            for obj in tier:
                                if journal is not None \
                                        and journal.is_object_done(obj, i):
                                    name = (f"{obj['kind']}/"
                                            f"{obj['metadata']['name']}")
                                    result.actions.append(
                                        f"journaled {name}")
                                    log(f"journaled {name} "
                                        "(already applied; resume)")
                                    _journal_skip(tel, "object")
                                    continue
                                todo.append(obj)
                            futures2 = [
                                (obj, pool.submit(_apply_one_cached,
                                                  client, obj, cache,
                                                  cache_lock, mode_state,
                                                  tier_span))
                                for obj in todo]
                            errors = []
                            for obj, fut in futures2:
                                name = (f"{obj['kind']}/"
                                        f"{obj['metadata']['name']}")
                                try:
                                    action = fut.result()
                                except SSAUnsupportedError:
                                    # strict ssa (apply_mode="ssa" / a
                                    # journal resumed in ssa): a server
                                    # without SSA aborts the rollout AS a
                                    # capability error, not a per-object
                                    # failure
                                    raise
                                except DeadlineExceeded:
                                    # the rollout budget is GLOBAL: one
                                    # exhausted attempt means every
                                    # sibling is out of time too —
                                    # surface the typed error, never a
                                    # per-object aggregate
                                    raise
                                except ApplyError as exc:
                                    errors.append(str(exc))
                                    continue
                                _log_downgrade_once(mode_state, log)
                                result.actions.append(f"{action} {name}")
                                log(f"{action} {name}")
                                if journal is not None:
                                    journal.set_mode(mode_state.current())
                                    journal.object_done(obj, i)
                            if errors:
                                # group barrier: nothing from group N+1
                                # (or a later tier) may start after a
                                # failure in group N
                                raise ApplyError(
                                    f"group {i + 1}: {len(errors)} "
                                    "object(s) failed: "
                                    + "; ".join(errors))
                result.timings["apply"] += time.monotonic() - t0

                t0 = time.monotonic()
                with _telemetry.maybe_span(tel, "crd-establish", "phase"):
                    for obj in group:
                        if obj.get("kind") != "CustomResourceDefinition":
                            continue
                        name = obj["metadata"]["name"]
                        with cache_lock:
                            live = cache.get(collection_path(obj),
                                             {}).get(name)
                        if not crd_established(live):
                            client.wait_crd_established(name,
                                                        stage_timeout,
                                                        poll)
                result.timings["crd-establish"] += time.monotonic() - t0

                if wait:
                    t0 = time.monotonic()
                    with cache_lock:
                        seed = {object_path(o):
                                cache.get(collection_path(o),
                                          {}).get(o["metadata"]["name"])
                                for o in group
                                if o.get("kind") in WORKLOAD_KINDS}
                    with _telemetry.maybe_span(tel, "ready-wait", "phase"):
                        stats = client.wait_ready(
                            group, stage_timeout, poll,
                            allow_empty_daemonsets, seed=seed,
                            watch=watch_ready)
                    result.timings["ready-wait"] += time.monotonic() - t0
                    _note_ready_stats(result, stats)
                    log(f"group {i + 1}/{len(groups)} ready")
            if journal is not None and wait:
                # converged-only, like the sequential engine: submit
                # without readiness must never be resumed as complete
                journal.group_done(i)
    result.apply_mode = mode_state.current()
    return result
