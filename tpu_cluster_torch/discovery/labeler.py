"""The node labeler: the counterpart of ``tpu_cluster/discovery/labeler.py``
for NVIDIA cards, with its arguments and output modes.

    python -m tpu_cluster_torch.discovery.labeler --accelerator h100-sxm5-80gb-8

Periodically discovers the card nodes (:mod:`.devices`) and patches the
labels from :func:`.labels.compute_labels` onto this Node through the
Kubernetes API (in-cluster ServiceAccount). With ``--conditions`` it also
publishes a ``GpuReady`` Node condition from the card census against the
host layout's card count.

Clusterless modes: ``--print`` writes each cycle's record as JSON to
stdout; ``--out-file`` appends it to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
import urllib.request
from typing import Optional

from . import devices as devs
from . import labels as lbl
from .. import topology


def node_patch(labels: dict) -> bytes:
    return json.dumps({"metadata": {"labels": labels}}).encode()


def gpu_ready_condition(accelerator: str, found_count: int, now: str = "",
                        previous: Optional[dict] = None) -> dict:
    """The GpuReady Node condition body. True iff the card census matches
    the host layout's card count; a node without cards reports False
    with its own reason.

    ``previous`` (the condition of the last cycle) keeps
    lastTransitionTime across heartbeats while the status holds; a
    restart of the labeler starts a fresh transition time."""
    expected = topology.get_host(accelerator).cards_per_host
    if found_count == expected:
        status, reason = "True", "AllGpusPresent"
        message = f"{found_count}/{expected} GPUs present"
    elif found_count == 0:
        status, reason = "False", "NoGpuDevices"
        message = f"no GPU device nodes (expected {expected})"
    else:
        status, reason = "False", "DegradedGpuSet"
        message = f"{found_count}/{expected} GPUs present"
    cond = {"type": "GpuReady", "status": status, "reason": reason,
            "message": message}
    if now:
        cond["lastHeartbeatTime"] = now
        if previous and previous.get("status") == status:
            cond["lastTransitionTime"] = previous.get(
                "lastTransitionTime", now)
        else:
            cond["lastTransitionTime"] = now
    return cond


def status_patch(condition: dict) -> bytes:
    return json.dumps({"status": {"conditions": [condition]}}).encode()


def _incluster_request(path: str, data: bytes) -> int:
    host = os.environ["KUBERNETES_SERVICE_HOST"]
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    sa = "/var/run/secrets/kubernetes.io/serviceaccount"
    with open(f"{sa}/token", encoding="utf-8") as f:
        token = f.read().strip()
    import ssl
    ctx = ssl.create_default_context(cafile=f"{sa}/ca.crt")
    req = urllib.request.Request(
        f"https://{host}:{port}{path}",
        data=data,
        method="PATCH",
        headers={
            "Authorization": f"Bearer {token}",
            "Content-Type": "application/strategic-merge-patch+json",
        },
    )
    with urllib.request.urlopen(req, context=ctx) as resp:
        return resp.status


def patch_node_incluster(node_name: str, labels: dict) -> int:
    """Strategic-merge-patch the Node using the in-cluster SA token."""
    return _incluster_request(f"/api/v1/nodes/{node_name}",
                              node_patch(labels))


def patch_node_condition_incluster(node_name: str, condition: dict) -> int:
    """Patch the Node's status subresource with the GpuReady condition.
    Strategic merge on conditions merges by `type`, so only ours moves."""
    return _incluster_request(f"/api/v1/nodes/{node_name}/status",
                              status_patch(condition))


def run_once(args: argparse.Namespace,
             previous_condition: Optional[dict] = None) -> dict:
    """One discovery and publish cycle. Returns ``{"labels": ..}`` plus
    ``"condition"`` when --conditions is on: the same record in every
    output mode (print, out-file, in-cluster patch)."""
    if args.fake_devices >= 0:
        # clusterless: a synthetic card census, so label-dependent
        # scheduling can be exercised on nodes without cards
        found = [devs.GpuDevice(i, f"/dev/nvidia{i}")
                 for i in range(args.fake_devices)]
    else:
        found = devs.discover(args.device_glob, args.devfs_root)
        if not found:
            found = devs.discover_vfio(args.devfs_root)
    labels = lbl.compute_labels(args.accelerator, found,
                                os.environ.get("NODE_NAME", ""))
    record: dict = {"labels": labels}
    if args.conditions:
        record["condition"] = gpu_ready_condition(
            args.accelerator, len(found),
            now=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            previous=previous_condition)
    condition = record.get("condition")
    if args.print_only:
        print(json.dumps(record, sort_keys=True))
    elif args.out_file:
        with open(args.out_file, "a", encoding="utf-8") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
    else:
        node = os.environ["NODE_NAME"]
        status = patch_node_incluster(node, labels)
        print(f"patched node {node}: HTTP {status}", file=sys.stderr)
        if condition:
            status = patch_node_condition_incluster(node, condition)
            print(f"patched node {node} condition GpuReady="
                  f"{condition['status']}: HTTP {status}", file=sys.stderr)
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-labeler")
    p.add_argument("--accelerator", default=topology.H100_SXM5_80GB_8.name,
                   help="the host layout (topology.HOST_TYPES)")
    p.add_argument("--device-glob", default="/dev/nvidia[0-9]*")
    p.add_argument("--devfs-root", default="")
    p.add_argument("--fake-devices", type=int, default=-1,
                   help="synthesize N cards instead of scanning the device "
                        "tree (clusterless)")
    p.add_argument("--interval", type=float, default=60)
    p.add_argument("--conditions", action="store_true",
                   help="also publish the GpuReady Node condition")
    p.add_argument("--oneshot", action="store_true")
    p.add_argument("--print", dest="print_only", action="store_true")
    p.add_argument("--out-file", default="")
    args = p.parse_args(argv)
    # a permanent configuration error must crash the pod, not retry forever
    try:
        topology.get_host(args.accelerator)
    except KeyError as exc:
        print(f"fatal: {exc}", file=sys.stderr)
        return 2
    if not (args.print_only or args.out_file) and not os.environ.get("NODE_NAME"):
        print("fatal: NODE_NAME env not set (downward-API fieldRef missing "
              "from the DaemonSet manifest?)", file=sys.stderr)
        return 2
    previous_condition: Optional[dict] = None
    failures = 0
    while True:
        try:
            record = run_once(args, previous_condition)
            previous_condition = record.get("condition")
            failures = 0
        except Exception as exc:  # keep the daemon alive across apiserver blips
            if args.oneshot:
                raise
            failures += 1
            print(f"label refresh failed (will retry): {exc}", file=sys.stderr)
        if args.oneshot:
            return 0
        # exponential backoff on apiserver errors, +/-10% jitter always; the
        # 5-min cap bounds only the backoff, a longer interval is kept
        delay = args.interval
        if failures:
            delay = min(args.interval * (2 ** failures),
                        max(300.0, args.interval))
        time.sleep(delay * random.uniform(0.9, 1.1))


if __name__ == "__main__":
    sys.exit(main())
