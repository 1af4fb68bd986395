"""Render the port's validation Jobs: the counterpart of
``tpu_cluster/render/jobs.py``. Each Job requests ``nvidia.com/gpu``,
selects nodes labelled ``nvidia.com/gpu.present=true``
(:mod:`..discovery.labels`) and runs
``python -m tpu_cluster_torch.workloads.validate`` with the reference's
arguments (on a card, validate's device is the card):

  gpu-device-query    whole host  the cards torch sees
  gpu-vector-add      1 card      add, checked element by element
  gpu-matmul          1 card      bf16 matmul throughput
  gpu-psum            whole host  the collective matrix over NCCL
  gpu-psum-multihost  N hosts     the same across hosts: an Indexed Job and
  gpu-burnin-multihost            a headless Service give each pod a stable
                                  DNS name and the TPU_WORKER_* env that
                                  ``workloads/multihost.plan`` reads

    python -m tpu_cluster_torch.render.jobs --accelerator h100-sxm5-80gb-1 [--multihost-hosts N]

prints them as one JSON ``v1`` List, which ``kubectl apply -f`` takes.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from ..discovery.labels import PRESENT
from ..spec import GpuSpec, SpecError
from ..workloads.multihost import DEFAULT_COORDINATOR_PORT

# the bundle linter's acknowledgement of an intended host access
LINT_ALLOW_ANNOTATION = "tpu-stack.dev/lint-allow"
VALIDATE = ["python", "-m", "tpu_cluster_torch.workloads.validate"]


def _meta(name: str, spec: GpuSpec, component: str) -> Dict[str, Any]:
    return {
        "name": name,
        "namespace": spec.namespace,
        "labels": {
            "app.kubernetes.io/name": name,
            "app.kubernetes.io/part-of": "tpu-stack",
            "app.kubernetes.io/component": component,
        },
    }


def _job(spec: GpuSpec, name: str, args: List[str], cards: int,
         backoff_limit: int = 0) -> Dict[str, Any]:
    """A batch/v1 Job running the validate entry point on ``cards`` cards."""
    resource = spec.resource_name
    pod_spec: Dict[str, Any] = {
        "restartPolicy": "Never",
        "nodeSelector": {PRESENT: "true"},
        "containers": [{
            "name": "validate",
            "image": spec.image,
            "command": list(VALIDATE),
            "args": args,
            "resources": {
                "limits": {resource: str(cards)},
                "requests": {resource: str(cards)},
            },
            # the Job's gauges go to /run/tpu/metrics.d, where the
            # exporter reads them (runtime_metrics)
            "volumeMounts": [{"name": "runtime-metrics",
                              "mountPath": "/run/tpu"}],
        }],
        "volumes": [{"name": "runtime-metrics",
                     "hostPath": {"path": "/run/tpu",
                                  "type": "DirectoryOrCreate"}}],
    }
    meta = _meta(name, spec, "validation")
    # the hostPath mount is intended: acknowledge it to the bundle linter
    meta["annotations"] = {LINT_ALLOW_ANNOTATION: "hostPath"}
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": meta,
        "spec": {
            "backoffLimit": backoff_limit,
            "template": {
                "metadata": {"labels": {"app.kubernetes.io/name": name}},
                "spec": pod_spec,
            },
        },
    }


def device_query_job(spec: GpuSpec) -> Dict[str, Any]:
    """Every card of the host; the count must equal the host layout's."""
    cards = spec.host_type.cards_per_host
    return _job(spec, "gpu-device-query",
                ["--mode=device-query", f"--expect-devices={cards}"], cards)


def vector_add_job(spec: GpuSpec) -> Dict[str, Any]:
    return _job(spec, "gpu-vector-add", ["--mode=vector-add"], 1)


def matmul_job(spec: GpuSpec) -> Dict[str, Any]:
    return _job(spec, "gpu-matmul", ["--mode=matmul"], 1)


def psum_job(spec: GpuSpec) -> Dict[str, Any]:
    """The collective matrix over the host's cards."""
    cards = spec.host_type.cards_per_host
    return _job(spec, "gpu-psum", ["--mode=psum"], cards)


def multihost_psum_job(spec: GpuSpec, num_hosts: int = 2,
                       mode: str = "psum") -> List[Dict[str, Any]]:
    """An Indexed Job over ``num_hosts`` hosts of the layout, every card
    of each, and the headless Service that gives each pod the stable DNS
    name the coordinator address needs. ``mode`` is validate's: "psum"
    (the collective matrix) or "burnin" (the sharded train step).

    Env contract per pod (read by ``workloads/multihost.plan``):
      JOB_COMPLETION_INDEX  set by the Indexed completion mode
      TPU_WORKER_HOSTNAMES  every pod's stable FQDN, in index order
      TPU_COORDINATOR_PORT  the first pod's rendezvous port
    """
    if num_hosts < 2:
        raise ValueError(f"multihost job needs >= 2 hosts, got {num_hosts}")
    name = f"gpu-{mode}-multihost"
    svc_name = name
    ns = spec.namespace
    cards = spec.host_type.cards_per_host
    hostnames = [f"{name}-{i}.{svc_name}.{ns}.svc.cluster.local"
                 for i in range(num_hosts)]
    job = _job(spec, name, [f"--mode={mode}"], cards)
    job["spec"].update({
        "completionMode": "Indexed",
        "completions": num_hosts,
        "parallelism": num_hosts,
    })
    tmpl = job["spec"]["template"]
    tmpl["spec"]["subdomain"] = svc_name
    container = tmpl["spec"]["containers"][0]
    container["env"] = [
        {"name": "TPU_WORKER_HOSTNAMES", "value": ",".join(hostnames)},
        {"name": "TPU_COORDINATOR_PORT",
         "value": str(DEFAULT_COORDINATOR_PORT)},
    ]
    container["ports"] = [{"name": "coordinator",
                           "containerPort": DEFAULT_COORDINATOR_PORT}]
    svc = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": _meta(svc_name, spec, "validation"),
        "spec": {
            "clusterIP": "None",
            # workers start in any order: publish DNS for pods not yet
            # ready, or worker N races resolving worker 0's address
            "publishNotReadyAddresses": True,
            # batch/v1 adds the job-name label to every pod of the Job
            "selector": {"job-name": name},
            "ports": [{"name": "coordinator",
                       "port": DEFAULT_COORDINATOR_PORT}],
        },
    }
    return [svc, job]


def render_validation_jobs(spec: GpuSpec,
                           multihost_hosts: int = 0) -> List[Dict[str, Any]]:
    """All validation Jobs in runbook order: the four single-host Jobs,
    then the multi-host pairs for psum and burnin when
    ``multihost_hosts`` >= 2."""
    objs = [
        device_query_job(spec),
        vector_add_job(spec),
        matmul_job(spec),
        psum_job(spec),
    ]
    if multihost_hosts >= 2:
        objs.extend(multihost_psum_job(spec, multihost_hosts))
        objs.extend(multihost_psum_job(spec, multihost_hosts, mode="burnin"))
    return objs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_cluster_torch.render.jobs")
    defaults = GpuSpec()
    p.add_argument("--accelerator", default=defaults.accelerator,
                   help="the host layout (topology.HOST_TYPES)")
    p.add_argument("--namespace", default=defaults.namespace)
    p.add_argument("--image", default=defaults.image)
    p.add_argument("--multihost-hosts", type=int, default=0)
    args = p.parse_args(argv)
    try:
        spec = GpuSpec(accelerator=args.accelerator,
                       namespace=args.namespace, image=args.image).validate()
    except SpecError as exc:
        print(f"spec error: {exc}", file=sys.stderr)
        return 2
    items = render_validation_jobs(spec, args.multihost_hosts)
    print(json.dumps({"apiVersion": "v1", "kind": "List", "items": items},
                     indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
