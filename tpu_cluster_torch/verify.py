"""Executable acceptance runbook: the counterpart of
``tpu_cluster/verify.py``, with the GPU's names.

The upstream GPU Operator's test strategy is a human runbook: run a
kubectl command, compare with a pasted expected output. This module turns
each check into an executable assertion over ``kubectl -o json`` (JSON
paths instead of grep), one per validation config plus the operand/label
checks in between. ``python -m tpu_cluster_torch verify`` runs them;
tests inject a canned runner.

A *runner* is ``callable(argv: List[str]) -> (returncode, stdout_text)`` —
the only seam between these checks and a live cluster.

Where the reference has accelerator content the port has the GPU's:
operand pods ``gpu-*``, the ``nvidia.com/gpu.present=true`` label, the
``GpuReady`` condition, ``nvidia.com/gpu`` = the host layout's
``cards_per_host``, the ``gpu-*`` validation Jobs, and the metrics scrape
of dcgm-exporter's default counters (``DCGM_FI_DEV_FB_USED`` and
``DCGM_FI_DEV_FB_FREE``, one sample per card) where the reference reads
its own exporter's ``tpu_chips_total`` and ``tpu_hbm_capacity_bytes``.
A GPU host layout is one host, so the reference's multi-host slice
branch (Indexed worker-set Jobs in place of the single-pod ones) has no
counterpart: the port's multi-host Jobs are the optional
``gpu-psum-multihost``/``gpu-burnin-multihost`` pairs of single hosts.
"""

from __future__ import annotations

import json
import re
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .kubeapply import FIELD_MANAGER, OPERATOR_FIELD_MANAGER
from .spec import ClusterSpec
from .telemetry import (OPERATOR_METRIC_NAMES, VERIFY_KUBECTL_CALLS,
                        MetricsRegistry)

Runner = Callable[[List[str]], Tuple[int, str]]

# Field managers expected on stack objects under server-side apply: the
# CLI's and the in-cluster operator's (imported from kubeapply so the
# runbook can never drift from the names the appliers actually use), plus
# the cluster components that legitimately write status/scale on every
# cluster. Anything else in managedFields is a FOREIGN manager — a manual
# `kubectl edit` / `kubectl apply` that the next stack reconcile will
# force-revert; check_ownership surfaces it before that happens.
KNOWN_FIELD_MANAGERS = frozenset({
    FIELD_MANAGER, OPERATOR_FIELD_MANAGER,
    "kubelet", "kube-controller-manager", "kube-scheduler",
    # The kubectl BACKEND (`apply` without --apiserver) deploys
    # through kubectl itself, which records these managers on every
    # object it creates/applies — they cannot be "foreign" on a cluster
    # the tool deployed that way. The cost: a human's own `kubectl
    # apply -f` is indistinguishable and passes too; `kubectl edit` /
    # `kubectl patch` still surface (managers "kubectl-edit" /
    # "kubectl-patch").
    "kubectl-client-side-apply", "kubectl-create",
})


class ClusterSnapshot:
    """Point-in-time read cache over a Runner — the informer analog for the
    runbook. Every check used to pay its own kubectl subprocess for data a
    sibling already fetched (smoke and allocatable each list nodes; labels
    and conditions each list the labeled subset). Wrapping the runner in a
    snapshot makes each distinct invocation hit the cluster ONCE per
    ``run_checks`` call and fan the result out to every check that asks.

    A snapshot IS a Runner (same callable seam), so the checks and the
    canned test runners compose with it unchanged. It is safe under the
    concurrent check dispatch in :func:`run_checks`: the first asker of a
    key becomes its fetcher and later askers park on an Event instead of
    double-spawning kubectl. Snapshots are single-shot by design — a fresh
    one per runbook run, never reused across runs (staleness is the point:
    all checks judge the same instant).

    Fetch accounting lives in a telemetry registry
    (``tpuctl_verify_kubectl_calls_total`` — pass your own
    :class:`~tpu_cluster_torch.telemetry.MetricsRegistry` to aggregate runbook
    runs into a larger surface); ``fetches`` reads the counter, so the
    CLI's ``kubectl_calls`` JSON field and the registry can never
    disagree."""

    def __init__(self, runner: Runner,
                 registry: Optional[MetricsRegistry] = None):
        self._runner = runner
        self._lock = threading.Lock()
        self._done: Dict[Tuple[str, ...], Tuple[int, str]] = {}  # guarded-by: _lock
        self._inflight: Dict[Tuple[str, ...], threading.Event] = {}  # guarded-by: _lock
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self._fetch_counter = self.registry.counter(
            VERIFY_KUBECTL_CALLS,
            "kubectl invocations the snapshot actually made")

    @property
    def fetches(self) -> int:
        """Underlying runner invocations actually made (the registry
        counter's value — the runbook's one source of request truth)."""
        return int(self._fetch_counter.value)

    def __call__(self, argv: List[str]) -> Tuple[int, str]:
        key = tuple(argv)
        while True:
            with self._lock:
                if key in self._done:
                    return self._done[key]
                event = self._inflight.get(key)
                if event is None:
                    self._inflight[key] = threading.Event()
                    break
            event.wait()
        # count OUTSIDE the snapshot lock: the counter has its own, and
        # nesting the two would put the only lock-order edge in the
        # runbook stack (the lock-order monitor pins it flat)
        self._fetch_counter.inc()
        try:
            result = self._runner(list(argv))
        except BaseException:
            with self._lock:
                self._inflight.pop(key).set()  # waiters retry as fetchers
            raise
        with self._lock:
            self._done[key] = result
            self._inflight.pop(key).set()
        return result

OPERAND_PODS = ("gpu-driver-prep", "gpu-device-plugin",
                "gpu-feature-discovery", "gpu-metrics-exporter",
                "gpu-node-status-exporter")
VALIDATION_JOBS = ("gpu-device-query", "gpu-vector-add", "gpu-matmul",
                   "gpu-psum")

PRESENT_SELECTOR = "nvidia.com/gpu.present=true"
READY_CONDITION = "GpuReady"
# dcgm-exporter's default counters that name a card's framebuffer: one
# sample of each per card, labeled gpu="<index>"
DCGM_FB_FAMILIES = ("DCGM_FI_DEV_FB_USED", "DCGM_FI_DEV_FB_FREE")
# gauges the port's workloads publish through the runtime-metrics relay
WORKLOAD_GAUGES = ("tpu_duty_cycle_percent", "tpu_hbm_used_bytes",
                   "tpu_tensorcore_utilization_percent")


def subprocess_runner(argv: List[str]) -> Tuple[int, str]:
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=120)
    except FileNotFoundError:
        return 127, ""  # no kubectl on PATH -> each check FAILs, not a crash
    except subprocess.TimeoutExpired:
        return 124, ""
    return proc.returncode, proc.stdout


@dataclass
class CheckResult:
    name: str
    ok: bool
    detail: str

    def line(self) -> str:
        return f"[{'PASS' if self.ok else 'FAIL'}] {self.name}: {self.detail}"


def _kubectl_json(runner: Runner,
                  args: List[str]) -> Optional[Dict[str, Any]]:
    rc, out = runner(["kubectl", *args, "-o", "json"])
    if rc != 0:
        return None
    try:
        doc = json.loads(out)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


def check_smoke(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """Validation config 1: nodes Ready, kube-system pods healthy."""
    nodes = _kubectl_json(runner, ["get", "nodes"])
    if not nodes or not nodes.get("items"):
        return CheckResult("smoke", False, "kubectl get nodes failed or empty")
    not_ready = []
    for node in nodes["items"]:
        conds = {c["type"]: c["status"]
                 for c in node["status"].get("conditions", [])}
        if conds.get("Ready") != "True":
            not_ready.append(node["metadata"]["name"])
    if not_ready:
        return CheckResult("smoke", False, f"nodes not Ready: {not_ready}")
    pods = _kubectl_json(runner, ["get", "pods", "-n", "kube-system"])
    if pods is None:
        return CheckResult("smoke", False, "cannot list kube-system pods")
    bad = [p["metadata"]["name"] for p in pods["items"]
           if p["status"].get("phase") not in ("Running", "Succeeded")]
    if bad:
        return CheckResult("smoke", False, f"kube-system pods not up: {bad}")
    return CheckResult(
        "smoke", True,
        f"{len(nodes['items'])} nodes Ready, kube-system healthy")


def check_operands(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """Operand pod health."""
    enabled = {
        "gpu-driver-prep": spec.gpu.operand("driverPrep").enabled,
        "gpu-device-plugin": spec.gpu.operand("devicePlugin").enabled,
        "gpu-feature-discovery": spec.gpu.operand("featureDiscovery").enabled,
        "gpu-metrics-exporter": spec.gpu.operand("metricsExporter").enabled,
        "gpu-node-status-exporter":
            spec.gpu.operand("nodeStatusExporter").enabled,
    }
    pods = _kubectl_json(runner, ["get", "pods", "-n", spec.gpu.namespace])
    if pods is None:
        return CheckResult("operands", False,
                           f"cannot list pods in {spec.gpu.namespace}")
    running = [p["metadata"]["name"] for p in pods["items"]
               if p["status"].get("phase") == "Running"]
    missing = [name for name, on in enabled.items()
               if on and not any(r.startswith(name) for r in running)]
    if missing:
        return CheckResult("operands", False,
                           f"operand pods not Running: {missing}")
    return CheckResult("operands", True,
                       f"{len(running)} operand pods Running")


def check_labels(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """Node labels published by feature discovery."""
    nodes = _kubectl_json(runner, ["get", "nodes", "-l", PRESENT_SELECTOR])
    if not nodes or not nodes.get("items"):
        return CheckResult("labels", False,
                           f"no nodes labeled {PRESENT_SELECTOR}")
    names = [n["metadata"]["name"] for n in nodes["items"]]
    return CheckResult("labels", True, f"GPU nodes: {names}")


def check_conditions(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """GpuReady node condition (published by the labeler's
    ``--conditions``; the node-problem-detector-style health surface). A
    labeled GPU node whose card census degraded must show here before
    anything schedules onto it."""
    nodes = _kubectl_json(runner, ["get", "nodes", "-l", PRESENT_SELECTOR])
    if not nodes or not nodes.get("items"):
        return CheckResult("conditions", False,
                           f"no nodes labeled {PRESENT_SELECTOR}")
    bad = []
    for n in nodes["items"]:
        conds = {c.get("type"): c
                 for c in n["status"].get("conditions", [])}
        tr = conds.get(READY_CONDITION)
        if not tr or tr.get("status") != "True":
            why = (tr or {}).get("reason", "condition absent")
            bad.append(f'{n["metadata"]["name"]}: {why}')
    if bad:
        return CheckResult("conditions", False, "; ".join(bad))
    return CheckResult("conditions", True,
                       f"{READY_CONDITION}=True on "
                       f"{len(nodes['items'])} node(s)")


def check_allocatable(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """Extended resource in Allocatable: every card of the host layout."""
    want = spec.gpu.host_type.cards_per_host
    resource = spec.gpu.resource_name
    nodes = _kubectl_json(runner, ["get", "nodes"])
    if not nodes:
        return CheckResult("allocatable", False, "kubectl get nodes failed")
    per_node = {
        n["metadata"]["name"]:
            int(n["status"].get("allocatable", {}).get(resource, 0))
        for n in nodes["items"]
    }
    good = {k: v for k, v in per_node.items() if v == want}
    if not good:
        return CheckResult(
            "allocatable", False,
            f"no node advertises {resource}={want} (saw {per_node})")
    return CheckResult("allocatable", True,
                       f"{resource}={want} on {sorted(good)}")


def _trailing_json_object(text: str) -> Optional[Dict[str, Any]]:
    """Parse the JSON object at the tail of mixed pod logs: kubectl merges
    stdout with stderr warnings (torch, NCCL), so scan column-0 '{' lines from
    the last one backwards until a parse succeeds."""
    lines = text.splitlines()
    for i in range(len(lines) - 1, -1, -1):
        if not lines[i].startswith("{"):
            continue
        try:
            doc = json.loads("\n".join(lines[i:]))
        except ValueError:
            continue
        if isinstance(doc, dict):
            return doc
    return None


def _job_status(check: str, job: str, doc: Dict[str, Any]) -> CheckResult:
    want = (doc.get("spec") or {}).get("completions", 1)
    got = (doc.get("status") or {}).get("succeeded", 0)
    if got >= want:
        return CheckResult(check, True, f"{job} succeeded {got}/{want}")
    failed = (doc.get("status") or {}).get("failed", 0)
    return CheckResult(check, False,
                       f"{job} succeeded {got}/{want}, failed {failed}")


def _check_job(runner: Runner, spec: ClusterSpec, check: str,
               job: str) -> CheckResult:
    doc = _kubectl_json(runner,
                        ["get", "job", "-n", spec.gpu.namespace, job])
    if doc is None:
        return CheckResult(check, False, f"job {job} not found (render+apply "
                                         "it: render --only jobs)")
    return _job_status(check, job, doc)


def check_device_query(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """Validation config 2: the nvidia-smi analog Job — status AND golden
    output (the runbook pastes the expected table; we assert the parsed
    device count: every card of the host layout)."""
    job = "gpu-device-query"
    res = _check_job(runner, spec, "device-query", job)
    if not res.ok:
        return res
    rc, out = runner(["kubectl", "logs", "-n", spec.gpu.namespace,
                      f"job/{job}"])
    if rc != 0:
        # Fail closed (like the apply gates): a Job whose pods were GC'd
        # proves nothing about the current card set.
        return CheckResult("device-query", False,
                           f"{res.detail}, but logs unavailable — re-run "
                           "the job to confirm the device count")
    doc = _trailing_json_object(out)
    if doc is None:
        return CheckResult("device-query", False,
                           "job logs are not the expected JSON report")
    want = spec.gpu.host_type.cards_per_host
    got = doc.get("device_count")
    if got != want:
        return CheckResult("device-query", False,
                           f"job saw {got} devices, expected {want}")
    return CheckResult("device-query", True,
                       f"{res.detail}; {got}/{want} devices enumerated")


def check_vector_add(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """Validation config 3: the cuda-vector-add Job."""
    return _check_job(runner, spec, "vector-add", "gpu-vector-add")


def check_psum(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """Validation config 5: all-reduce over the host's cards (NCCL)."""
    return _check_job(runner, spec, "psum", "gpu-psum")


def check_burnin(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """The sharded DP x TP train-step Job across hosts: optional, present
    only when the user applied it via ``--multihost``. Only a confirmed
    job-absent 404 is treated as 'optional, pass' — a kubectl/transport
    failure fails closed like every other check."""
    job = "gpu-burnin-multihost"
    # --ignore-not-found: rc 0 + empty stdout is a CONFIRMED absence (the
    # optional case); any nonzero rc is a transport/RBAC failure and fails
    # closed (kubectl's NotFound text goes to stderr, which the runner
    # protocol doesn't carry — absence must be distinguished on stdout).
    rc, out = runner(["kubectl", "get", "job", "-n", spec.gpu.namespace,
                      job, "--ignore-not-found", "-o", "json"])
    if rc != 0:
        return CheckResult("burnin", False, "kubectl get job failed")
    if not out.strip():
        return CheckResult("burnin", True,
                           "not rendered (optional; "
                           "render --multihost N to enable)")
    try:
        doc = json.loads(out)
    except ValueError:
        return CheckResult("burnin", False, "kubectl returned invalid JSON")
    return _job_status("burnin", job, doc)


_GPU_LABEL = re.compile(r'[{,]gpu="([^"]*)"')


def check_metrics(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """Validation config 4: the exporter scrape, through the apiserver
    service proxy so it works from anywhere kubectl works. The exporter is
    dcgm-exporter: its default framebuffer counters must have a sample for
    every card of the host layout (distinct ``gpu="..."`` labels)."""
    port = spec.gpu.operand("metricsExporter").extra.get("port", 9400)
    rc, out = runner([
        "kubectl", "get", "--raw",
        f"/api/v1/namespaces/{spec.gpu.namespace}/services/"
        f"gpu-metrics-exporter:{port}/proxy/metrics",
    ])
    if rc != 0:
        return CheckResult("metrics", False, "service proxy scrape failed")
    want = spec.gpu.host_type.cards_per_host
    lines = out.splitlines()
    cards: Dict[str, int] = {}
    for family in DCGM_FB_FAMILIES:
        # sample lines only (not HELP/TYPE comments): an exporter that
        # found no card, or no DCGM, must fail here, not shrug
        cards[family] = len({m.group(1) for ln in lines
                             if ln.startswith(family + "{")
                             for m in [_GPU_LABEL.search(ln)] if m})
    short = {f: n for f, n in cards.items() if n < want}
    if short:
        return CheckResult(
            "metrics", False,
            "scrape lacks per-card samples: "
            + ", ".join(f"{f} for {n}/{want} card(s)"
                        for f, n in short.items()))
    line = ", ".join(f"{f} for {n} card(s)" for f, n in cards.items())
    # Workload-produced gauges (duty cycle / HBM used) only exist while a
    # workload is publishing — report their presence rather than failing
    # an idle node. Sample lines only.
    extras = [g for g in WORKLOAD_GAUGES
              if any(ln.startswith(g + "{") for ln in lines)]
    if extras:
        line += f" (+ workload gauges: {', '.join(extras)})"
    return CheckResult("metrics", True, line)


def fetch_policy(
        runner: Runner) -> Tuple[str, Optional[Dict[str, Any]]]:
    """Two-step TpuStackPolicy probe shared by :func:`check_policy` and
    ``triage`` — returns ``(state, cr)`` where state is ``"no-crd"`` /
    ``"no-cr"`` / ``"ok"`` / ``"error: ..."`` and cr is the parsed object
    only for ``"ok"``. Absence is probed with ``--ignore-not-found`` (rc 0,
    empty output), so an unreachable apiserver or RBAC denial surfaces as
    an error instead of masquerading as 'not installed'."""
    rc, out = runner(["kubectl", "get", "crd",
                      "tpustackpolicies.tpu-stack.dev",
                      "--ignore-not-found", "-o", "json"])
    if rc != 0:
        return f"error: cannot query CRDs (kubectl rc {rc})", None
    if not out.strip():
        return "no-crd", None
    rc, out = runner(["kubectl", "get", "tpustackpolicies.tpu-stack.dev",
                      "default", "--ignore-not-found", "-o", "json"])
    if rc != 0:
        return (f"error: cannot query TpuStackPolicy (kubectl rc {rc})",
                None)
    if not out.strip():
        return "no-cr", None
    try:
        doc = json.loads(out)
    except ValueError:
        return "error: unparseable TpuStackPolicy JSON", None
    if not isinstance(doc, dict):
        return "error: unparseable TpuStackPolicy JSON", None
    return "ok", doc


def policy_disabled_operands(cr: Optional[Dict[str, Any]]) -> List[str]:
    """Operand names the live CR's status reports as policy-disabled."""
    status = (cr or {}).get("status") or {}
    return sorted(name for name, op in (status.get("operands") or {}).items()
                  if not op.get("enabled"))


# Seconds a TpuStackPolicy CR may exist without ANY status before its
# absence counts as "operator not reconciling". The operator's probe
# cadence is 2s and image pull tops out around a minute; the rest of the
# window absorbs client-vs-apiserver clock skew — the age is computed
# against the LOCAL clock (kubectl exposes no server time), so a client
# running a few minutes fast must not turn a healthy fresh install red.
POLICY_STATUS_GRACE_S = 300


def _cr_age_seconds(cr: Dict[str, Any]) -> Optional[float]:
    """Age from metadata.creationTimestamp (RFC3339 UTC); None if absent
    or unparseable."""
    ts = (cr.get("metadata") or {}).get("creationTimestamp")
    if not ts:
        return None
    try:
        import calendar
        parsed = time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ")
        return max(0.0, time.time() - calendar.timegm(parsed))
    except (ValueError, TypeError):
        return None


def check_policy(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """TpuStackPolicy health (operator mode's ClusterPolicy analog): the
    controller's status must be current (observedGeneration == generation)
    and Ready. Genuine absence passes with a note — the plain ``apply``
    and helm-only paths never install the CRD, and the operator
    itself fails open on a deleted CR."""
    state, cr = fetch_policy(runner)
    if state.startswith("error"):
        return CheckResult("policy", False, state[len("error: "):])
    if state == "no-crd":
        return CheckResult("policy", True,
                           "TpuStackPolicy CRD not installed "
                           "(operator-managed rollouts only)")
    if state == "no-cr":
        return CheckResult("policy", True,
                           "CRD installed but 'default' CR absent — "
                           "operator fails open (all operands enabled)")
    assert cr is not None  # state == "ok" guarantees a parsed CR
    st = cr.get("status") or {}
    gen = cr.get("metadata", {}).get("generation")
    observed = st.get("observedGeneration")
    if not st:
        # Freshly-installed operator: the CR exists before the first status
        # write-back lands. A young CR with NO status at all is a pending
        # first reconcile, not a stale one — `verify` right after a
        # healthy `apply --operator` must not be transiently red.
        age = _cr_age_seconds(cr)
        if age is None or age < POLICY_STATUS_GRACE_S:
            return CheckResult(
                "policy", True,
                f"status not yet written (CR age "
                f"{'unknown' if age is None else round(age)}s < "
                f"{POLICY_STATUS_GRACE_S}s grace) — operator's first "
                "reconcile pending")
        return CheckResult(
            "policy", False,
            f"no status {round(age)}s after CR creation "
            "(operator not running?)")
    if gen is not None and observed != gen:
        return CheckResult("policy", False,
                           f"status stale: observedGeneration={observed} "
                           f"!= generation={gen} (operator not reconciling?)")
    if st.get("phase") != "Ready":
        return CheckResult("policy", False,
                           f"phase={st.get('phase', 'absent')}")
    disabled = policy_disabled_operands(cr)
    line = f"Ready, {st.get('readySummary', '?')}"
    if disabled:
        line += f" (disabled by policy: {', '.join(disabled)})"
    return CheckResult("policy", True, line)


# Stack object kinds whose field ownership the runbook audits — the
# kinds the appliers manage in the operand namespace (workloads + the
# config/identity objects a manual edit most plausibly touches).
_OWNERSHIP_KINDS = ("daemonsets", "deployments", "services",
                    "serviceaccounts", "configmaps")


def check_ownership(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """Field-ownership drift (server-side apply round): list the stack's
    objects WITH managedFields and flag any field manager that is not
    tpuctl / tpu-operator (the field managers) / a known cluster
    component. A foreign manager
    means someone `kubectl edit`-ed or `kubectl patch`-ed over the stack:
    where their edit touches fields the bundle specifies, the next
    reconcile's force-apply reverts it; a purely ADDITIVE edit persists
    outside the stack's ownership. Either way it is unmanaged drift this
    check makes visible, naming the object, the manager and its
    operation."""
    doc = _kubectl_json(runner, ["get", ",".join(_OWNERSHIP_KINDS),
                                 "-n", spec.gpu.namespace,
                                 "--show-managed-fields"])
    if doc is None:
        return CheckResult("ownership", False,
                           f"cannot list stack objects in "
                           f"{spec.gpu.namespace}")
    foreign: List[str] = []
    managed = 0
    for item in doc.get("items") or []:
        meta = item.get("metadata") or {}
        entries = meta.get("managedFields") or []
        if entries:
            managed += 1
        kind = item.get("kind", "?")
        name = meta.get("name", "?")
        for entry in entries:
            mgr = entry.get("manager")
            if mgr and mgr not in KNOWN_FIELD_MANAGERS:
                foreign.append(
                    f"{kind}/{name}: {mgr} "
                    f"({entry.get('operation', '?')})")
    if foreign:
        return CheckResult(
            "ownership", False,
            "foreign field manager(s) — manual edits (contested fields "
            "are force-reverted by the next reconcile; additive ones "
            "persist unmanaged): " + "; ".join(sorted(foreign)))
    return CheckResult(
        "ownership", True,
        f"{managed} object(s) owned by "
        f"{FIELD_MANAGER}/{OPERATOR_FIELD_MANAGER} only")


def check_operator_metrics(runner: Runner, spec: ClusterSpec) -> CheckResult:
    """The operator's /metrics scrape against the PINNED metric-name
    table (telemetry.OPERATOR_METRIC_NAMES — the twin of
    kubeapi::OperatorMetricNames()): every family the fleet dashboards
    and the metrics-driven autoscaler key on must be present, by name,
    on the live endpoint. A missing family FAILs — a renamed metric is a
    broken dashboard, caught here instead of on the Grafana screen.
    Genuine operator absence (no gpu-operator Service) passes with a
    note, like check_policy: plain ``apply`` installs no operator."""
    from .render.operator_bundle import OPERATOR_NAME, STATUS_PORT
    rc, out = runner(["kubectl", "get", "service", "-n",
                      spec.gpu.namespace, OPERATOR_NAME,
                      "--ignore-not-found", "-o", "json"])
    if rc != 0:
        return CheckResult("operator-metrics", False,
                           f"cannot query the {OPERATOR_NAME} service "
                           f"(kubectl rc {rc})")
    if not out.strip():
        return CheckResult("operator-metrics", True,
                           "operator not installed (apply "
                           "--operator deploys it); nothing to scrape")
    rc, out = runner([
        "kubectl", "get", "--raw",
        f"/api/v1/namespaces/{spec.gpu.namespace}/services/"
        f"{OPERATOR_NAME}:{STATUS_PORT}/proxy/metrics",
    ])
    if rc != 0:
        return CheckResult("operator-metrics", False,
                           "operator /metrics scrape failed (service "
                           "proxy)")
    lines = out.splitlines()
    missing = [name for name in OPERATOR_METRIC_NAMES
               if not any(ln.startswith(name) for ln in lines)]
    if missing:
        return CheckResult(
            "operator-metrics", False,
            f"scrape lacks pinned metric families: {missing}")
    return CheckResult(
        "operator-metrics", True,
        f"all {len(OPERATOR_METRIC_NAMES)} pinned metric families "
        "present")


CHECKS: Dict[str, Callable[[Runner, ClusterSpec], CheckResult]] = {
    "smoke": check_smoke,
    "operands": check_operands,
    "labels": check_labels,
    "conditions": check_conditions,
    "allocatable": check_allocatable,
    "policy": check_policy,
    "ownership": check_ownership,
    "device-query": check_device_query,
    "vector-add": check_vector_add,
    "metrics": check_metrics,
    "operator-metrics": check_operator_metrics,
    "psum": check_psum,
    "burnin": check_burnin,
}


def run_checks(names: List[str], spec: ClusterSpec,
               runner: Runner = subprocess_runner) -> List[CheckResult]:
    """Run the named checks against one :class:`ClusterSnapshot` of the
    runner (pass a snapshot yourself to read its ``fetches`` afterwards).
    Checks are independent reads, so they dispatch concurrently through
    the seam — results come back in request order regardless."""
    unknown = [n for n in names if n not in CHECKS]
    if unknown:
        raise KeyError(f"unknown checks {unknown}; known: {list(CHECKS)}")
    if not isinstance(runner, ClusterSnapshot):
        runner = ClusterSnapshot(runner)
    if len(names) == 1:
        return [CHECKS[names[0]](runner, spec)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(8, len(names))) as pool:
        futures = [pool.submit(CHECKS[n], runner, spec) for n in names]
        return [f.result() for f in futures]
