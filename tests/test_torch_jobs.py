"""The port's validation Jobs against the reference's renderer
(``tpu_cluster/render/jobs.py``) for a host of the same size: after the
stated substitutions (resource, node label, module, name prefix) every
document is equal, so counts, args, the multi-host env contract, the
mounts and the Indexed-Job fields all carry over; and the CLI prints JSON
that requests ``nvidia.com/gpu`` and runs the port's validate."""

import json
import subprocess
import sys

import pytest

from tpu_cluster import spec as ref_specmod
from tpu_cluster.render import jobs as ref_jobs
from tpu_cluster.render import manifests as ref_manifests
from tpu_cluster.workloads import multihost as ref_multihost
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch.render import jobs
from tpu_cluster_torch.workloads import multihost

# reference string -> the port's; the label before the resource it contains
SUBSTITUTIONS = (
    ("google.com/tpu.present", "nvidia.com/gpu.present"),
    ("google.com/tpu", "nvidia.com/gpu"),
    ("tpu_cluster.workloads.validate", "tpu_cluster_torch.workloads.validate"),
    ("tpu-device-query", "gpu-device-query"),
    ("tpu-vector-add", "gpu-vector-add"),
    ("tpu-matmul", "gpu-matmul"),
    ("tpu-psum", "gpu-psum"),
    ("tpu-burnin", "gpu-burnin"),
)
SAME_SIZE = [("v5e-8", "h100-sxm5-80gb-8"), ("v5e-1", "h100-sxm5-80gb-1")]


def _substituted(objs):
    text = json.dumps(objs, sort_keys=True)
    for old, new in SUBSTITUTIONS:
        text = text.replace(old, new)
    return json.loads(text)


def _specs(ref_acc, acc):
    ref = ref_specmod.default_spec()
    ref.tpu.accelerator = ref_acc
    ref.validate()
    port = specmod.GpuSpec(accelerator=acc, namespace=ref.tpu.namespace,
                           image=ref_manifests.DEFAULT_IMAGE).validate()
    return ref, port


@pytest.mark.parametrize("hosts", [0, 2, 3])
@pytest.mark.parametrize("ref_acc,acc", SAME_SIZE)
def test_jobs_equal_reference_after_substitutions(ref_acc, acc, hosts):
    ref, port = _specs(ref_acc, acc)
    want = ref_jobs.render_validation_jobs(ref, multihost_hosts=hosts)
    got = jobs.render_validation_jobs(port, multihost_hosts=hosts)
    assert json.loads(json.dumps(got, sort_keys=True)) == _substituted(want)
    assert len(got) == (4 if hosts < 2 else 8)


def test_multihost_env_contract_is_what_the_ports_plan_reads(monkeypatch):
    assert multihost.DEFAULT_COORDINATOR_PORT == \
        ref_multihost.DEFAULT_COORDINATOR_PORT
    _, port = _specs("v5e-8", "h100-sxm5-80gb-8")
    svc, job = jobs.multihost_psum_job(port, num_hosts=3, mode="burnin")
    assert svc["kind"] == "Service" and svc["spec"]["clusterIP"] == "None"
    spec = job["spec"]
    assert (spec["completionMode"], spec["completions"],
            spec["parallelism"]) == ("Indexed", 3, 3)
    container = spec["template"]["spec"]["containers"][0]
    assert container["resources"]["limits"] == {"nvidia.com/gpu": "8"}
    assert container["volumeMounts"] == [{"name": "runtime-metrics",
                                          "mountPath": "/run/tpu"}]
    env = {e["name"]: e["value"] for e in container["env"]}
    monkeypatch.delenv("TPU_WORKER_ID", raising=False)
    monkeypatch.setenv("JOB_COMPLETION_INDEX", "2")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    plan = multihost.plan()
    assert plan["multihost"] and plan["num_processes"] == 3
    assert plan["process_id"] == 2
    assert plan["coordinator_address"] == (
        "gpu-burnin-multihost-0.gpu-burnin-multihost."
        f"{port.namespace}.svc.cluster.local:"
        f"{multihost.DEFAULT_COORDINATOR_PORT}")


def test_multihost_needs_two_hosts_and_spec_errors():
    with pytest.raises(ValueError, match=">= 2 hosts"):
        jobs.multihost_psum_job(specmod.GpuSpec().validate(), num_hosts=1)
    with pytest.raises(specmod.SpecError, match="unknown host type 'v5e-8'"):
        specmod.GpuSpec(accelerator="v5e-8").validate()
    with pytest.raises(specmod.SpecError, match="image"):
        specmod.GpuSpec(image="").validate()
    assert specmod.GpuSpec(accelerator=" H100-SXM5-80GB-1 ").validate() \
        .accelerator == "h100-sxm5-80gb-1"


def test_cli_prints_a_json_list_of_jobs_on_nvidia_gpus():
    out = subprocess.run(
        [sys.executable, "-m", "tpu_cluster_torch.render.jobs",
         "--accelerator", "h100-sxm5-80gb-1", "--multihost-hosts", "2"],
        capture_output=True, text=True, check=True, timeout=60)
    doc = json.loads(out.stdout)
    assert (doc["apiVersion"], doc["kind"]) == ("v1", "List")
    kinds = [o["kind"] for o in doc["items"]]
    assert kinds == ["Job"] * 4 + ["Service", "Job"] * 2
    for o in doc["items"]:
        if o["kind"] != "Job":
            continue
        pod = o["spec"]["template"]["spec"]
        container = pod["containers"][0]
        assert container["command"] == [
            "python", "-m", "tpu_cluster_torch.workloads.validate"]
        assert set(container["resources"]["limits"]) == {"nvidia.com/gpu"}
        assert pod["nodeSelector"] == {"nvidia.com/gpu.present": "true"}
    bad = subprocess.run(
        [sys.executable, "-m", "tpu_cluster_torch.render.jobs",
         "--accelerator", "v5e-8"], capture_output=True, text=True,
        timeout=60)
    assert bad.returncode == 2 and "unknown host type" in bad.stderr
