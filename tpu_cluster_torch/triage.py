"""Failure-triage runbook, executable: the counterpart of
``tpu_cluster/triage.py``, with the GPU's names.

The GPU Operator's troubleshooting section is three manual steps:
describe the failing pod, read the driver container's logs, and confirm
the instance really has a GPU. ``python -m tpu_cluster_torch triage``
executes that runbook against every operand and folds in the node-status
and feature-discovery surfaces, producing one report.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List

from .spec import ClusterSpec
from .verify import READY_CONDITION, Runner, subprocess_runner

# The Lease the operator Deployment elects on: operator_bundle renders
# `--leader-elect` and no `--lease-name`, so it is the native operator's
# default name.
OPERATOR_LEASE = "tpu-operator"
# Where NVIDIA's device plugin registers with the kubelet.
DEVICE_PLUGIN_SOCKET = "/var/lib/kubelet/device-plugins/nvidia-gpu.sock"


@dataclass
class TriageReport:
    sections: List[str] = field(default_factory=list)

    def add(self, title: str, body: str):
        self.sections.append(f"=== {title} ===\n{body.rstrip()}\n")

    def text(self) -> str:
        return "\n".join(self.sections)


def run_triage(spec: ClusterSpec,
               runner: Runner = subprocess_runner) -> TriageReport:
    ns = spec.gpu.namespace
    report = TriageReport()

    # 1. pod inventory with phases (the "kubectl get pods" first look)
    rc, out = runner(["kubectl", "get", "pods", "-n", ns, "-o", "json"])
    problem_pods: List[str] = []
    admission_errors: List[tuple] = []
    if rc != 0:
        report.add(f"pods in {ns}", "ERROR: cannot list pods — is the stack "
                                    "installed? (apply)")
    else:
        lines = []
        for pod in json.loads(out).get("items", []):
            name = pod["metadata"]["name"]
            phase = pod["status"].get("phase", "?")
            lines.append(f"{name}  {phase}")
            if phase not in ("Running", "Succeeded"):
                problem_pods.append(name)
            if pod["status"].get("reason") == "UnexpectedAdmissionError":
                admission_errors.append(
                    (name, pod["status"].get("message", "")))
        report.add(f"pods in {ns}", "\n".join(lines) or "(none)")

    # 1b. UnexpectedAdmissionError = the device plugin rejected Allocate
    # (a nvidia.com/gpu request the node cannot satisfy); surface the
    # plugin's reason and the valid counts right here instead of making
    # the user decode a gRPC error string. A GPU host has no aligned
    # sub-mesh shapes: any whole count of its cards is valid (lint R05).
    if admission_errors:
        from . import topology
        body = []
        for name, message in admission_errors:
            body.append(f"{name}: {message or '(no status message)'}")
        try:
            host = topology.get_host(spec.gpu.accelerator)
            body.append(
                f"fix: request a whole {spec.gpu.resource_name} count "
                f"between 1 and {host.cards_per_host} for {host.name} "
                "(request == limit)")
        except KeyError:
            pass
        report.add("UnexpectedAdmissionError pods (unsatisfiable GPU "
                   "request)", "\n".join(body))

    # 2. describe + logs for every problem pod
    for pod in problem_pods:
        rc, out = runner(["kubectl", "describe", "pod", "-n", ns, pod])
        report.add(f"describe {pod}", out if rc == 0 else "describe failed")
        rc, out = runner(["kubectl", "logs", "-n", ns, pod, "--tail=50"])
        report.add(f"logs {pod}", out if rc == 0 else "logs unavailable")

    # 2b. recent Warning events — the operator posts ApplyFailed /
    # StageTimeout onto operand objects when a rollout wedges
    rc, out = runner(["kubectl", "get", "events", "-n", ns,
                      "--field-selector=type=Warning",
                      "--sort-by=.lastTimestamp", "-o", "json"])
    if rc == 0:
        rows = []
        for ev in json.loads(out).get("items", []):
            inv = ev.get("involvedObject", {})
            rows.append(f"{ev.get('reason', '?')}  "
                        f"{inv.get('kind', '?')}/{inv.get('name', '?')}: "
                        f"{ev.get('message', '')}")
        if rows:
            report.add(f"warning events in {ns}", "\n".join(rows[-20:]))

    # 2c. policy-disabled operands: "where did my exporter go?" has a
    # one-line answer when the TpuStackPolicy toggled it off — the operator
    # deleted it on purpose, and status says so (operator-mode installs
    # only; the CR is simply absent elsewhere, and triage ignores fetch
    # errors — check_policy is the strict surface)
    from .verify import fetch_policy, policy_disabled_operands
    state, cr = fetch_policy(runner)
    if state == "ok":
        disabled = policy_disabled_operands(cr)
        if disabled:
            report.add(
                "operands disabled by TpuStackPolicy",
                "\n".join(f"{n}: rolled out of the cluster by the operator "
                          "(re-enable: kubectl patch tsp default --type "
                          "merge -p '{\"spec\":{\"operands\":{\"" + n +
                          "\":{\"enabled\":true}}}}')"
                          for n in disabled))

    # 2d. operator leader election: with >1 replica, "why is this
    # operator pod idle?" is usually "it is the standby" — show the Lease
    # holder so the answer is one read away. Absent Lease = leader
    # election not in use (single-replica default); ignore fetch errors.
    from .verify import _kubectl_json
    lease = _kubectl_json(runner, ["get", "lease", "-n", ns, OPERATOR_LEASE,
                                   "--ignore-not-found"])
    if lease:
        lease_spec = lease.get("spec", {})
        holder = lease_spec.get("holderIdentity") or "(released)"
        report.add(
            "operator leader election",
            f"lease holder: {holder}\n"
            f"renewed: {lease_spec.get('renewTime', '?')} "
            f"(duration {lease_spec.get('leaseDurationSeconds', '?')}s, "
            f"transitions "
            f"{lease_spec.get('leaseTransitions', 0)})\n"
            "other replicas are standbys by design; a stale renewTime "
            "with a wedged stack means the holder is stuck — delete "
            "its pod to force a handoff")

    # 3. per-node health from the node-status-exporter (the automated
    # version of "confirm the instance really has a GPU"): the validator
    # in its metrics role serves Prometheus text on its status port
    if spec.gpu.operand("nodeStatusExporter").enabled:
        rc, out = runner([
            "kubectl", "get", "--raw",
            f"/api/v1/namespaces/{ns}/services/"
            f"gpu-node-status-exporter:9401/proxy/metrics",
        ])
        report.add("node GPU-stack status",
                   out if rc == 0 else
                   "status endpoint unreachable; on the node run: "
                   f"ls {spec.gpu.device_glob}  (device nodes present?)")

    # 4. device-plugin registration state + GpuReady conditions
    rc, out = runner(["kubectl", "get", "nodes", "-o", "json"])
    if rc == 0:
        resource = spec.gpu.resource_name
        rows, cond_rows = [], []
        for node in json.loads(out).get("items", []):
            name = node["metadata"]["name"]
            alloc = node["status"].get("allocatable", {}).get(resource, "0")
            rows.append(f"{name}  {resource}={alloc}")
            for cond in node["status"].get("conditions", []):
                if cond.get("type") == READY_CONDITION:
                    cond_rows.append(
                        f"{name}  {READY_CONDITION}={cond['status']} "
                        f"({cond.get('reason', '')}: "
                        f"{cond.get('message', '')})")
        report.add("allocatable per node (device-plugin registration)",
                   "\n".join(rows) or "(no nodes)")
        if cond_rows:
            report.add(f"{READY_CONDITION} node conditions (feature "
                       "discovery)",
                       "\n".join(cond_rows))

    hints = [
        "UnexpectedAdmissionError pods: request a whole "
        f"{spec.gpu.resource_name} count, request == limit, no more than "
        "the node's cards.",
        f"Resource missing from Allocatable: check the plugin pod and "
        f"{DEVICE_PLUGIN_SOCKET} on the node; the plugin re-registers "
        "after kubelet restarts.",
        f"No cards found: ls {spec.gpu.device_glob} on the node "
        "(control-plane nodes legitimately have none).",
    ]
    report.add("hints", "\n".join(f"- {h}" for h in hints))
    return report
