"""The port's smoke workloads and multi-host plan against the JAX
reference on the CPU: ``device_report``, ``vector_add``, ``matmul`` and
``run_suite`` give the reference's keys (values that name the device
aside), and ``multihost.plan`` resolves every env case as the
reference's does."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_cluster.workloads import multihost as ref_multihost
from tpu_cluster.workloads import smoke as ref_smoke
from tpu_cluster_torch.workloads import multihost, runtime_metrics, smoke


def test_device_report_keys_on_the_cpu():
    got, want = smoke.device_report("cpu"), ref_smoke.device_report()
    assert set(got) == set(want)
    assert set(got["devices"][0]) == set(want["devices"][0])
    assert got["platform"] == want["platform"] == "cpu"
    assert got["devices"] == [{"id": 0, "kind": "cpu", "process": 0}]
    assert (got["device_count"], got["local_device_count"],
            got["process_index"]) == (1, 1, 0)


def test_hbm_stats_empty_on_the_cpu():
    assert smoke.hbm_stats(torch.device("cpu")) == {}


def test_vector_add_matches_reference():
    got, want = smoke.vector_add(device="cpu"), ref_smoke.vector_add()
    assert got == want == {"check": "vector_add", "n": 1 << 20, "ok": True}


def test_matmul_keys_and_values():
    got = smoke.matmul(128, 128, 128, iters=2, device="cpu")
    want = ref_smoke.matmul(128, 128, 128, iters=2)
    assert set(got) == set(want)
    for key in ("check", "m", "k", "n", "dtype", "iters", "ok"):
        assert got[key] == want[key], key
    assert got["ok"] and got["dtype"] == "bfloat16" and got["tflops"] > 0


def test_matmul_chain_rejects_non_square_carry():
    with pytest.raises(ValueError, match="k == n"):
        smoke.matmul_chain(8, 8, 16, torch.bfloat16, 1, device="cpu")


def test_matmul_chain_is_the_chained_product():
    """The timed pass is ``iters`` products carried through one rhs with
    the 1/sqrt(k) scale, in bf16: held to the same chain in f32 numpy
    within bf16 rounding (2^-8 relative a product, three products)."""
    run, flops = smoke.matmul_chain(16, 32, 32, torch.bfloat16, 3,
                                    device="cpu")
    assert flops == 2.0 * 16 * 32 * 32 * 3
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((16, 32), generator=gen).to(torch.bfloat16)
    b = torch.randn((32, 32), generator=gen).to(torch.bfloat16)
    x = a.float().numpy()
    for _ in range(3):
        x = x @ b.float().numpy() / np.sqrt(32)
    with runtime_metrics.duty_cycle_window() as duty, \
            runtime_metrics.tensorcore_window() as tc:
        _, out = run()
    np.testing.assert_allclose(out.float().numpy(), x, rtol=0.05, atol=0.05)
    assert tc._total_flops == flops and duty.total_busy_s > 0


def test_run_suite_keys():
    got = smoke.run_suite(matmul_dim=128, device="cpu")
    want = ref_smoke.run_suite(matmul_dim=128)
    assert set(got) == set(want)
    for key in ("device_report", "vector_add", "matmul"):
        assert set(got[key]) == set(want[key]), key
    assert got["ok"] and want["ok"]


ENVS = {
    "empty": {},
    "single_host_localhost": {"TPU_WORKER_HOSTNAMES": "localhost"},
    "indexed_job": ref_multihost.bootstrap_env(
        1, ["job-0.tpu-job.default.svc", "job-1.tpu-job.default.svc"]),
    "completion_index_fallback": {"JOB_COMPLETION_INDEX": "3",
                                  "TPU_WORKER_HOSTNAMES": "a,b,c,d"},
    "worker_id_wins": {"TPU_WORKER_ID": "2", "JOB_COMPLETION_INDEX": "0",
                       "TPU_WORKER_HOSTNAMES": "a,b,c"},
    "custom_port": ref_multihost.bootstrap_env(0, ["h0", "h1"], port=9999),
    "empty_entries_dropped": {"TPU_WORKER_ID": "0",
                              "TPU_WORKER_HOSTNAMES": "h0,,h1,"},
}


@pytest.mark.parametrize("env", ENVS.values(), ids=list(ENVS))
def test_plan_matches_reference(env):
    assert multihost.plan(env) == ref_multihost.plan(env)


def test_bootstrap_env_matches_reference():
    hosts = ["job-0.svc", "job-1.svc"]
    assert multihost.bootstrap_env(1, hosts) == \
        ref_multihost.bootstrap_env(1, hosts)
    assert multihost.DEFAULT_COORDINATOR_PORT == \
        ref_multihost.DEFAULT_COORDINATOR_PORT


@pytest.mark.parametrize("env,match", [
    ({"TPU_WORKER_HOSTNAMES": "a,b"}, "completionMode"),
], ids=["missing_worker_id"])
def test_plan_errors_match_reference(env, match):
    for mod in (multihost, ref_multihost):
        with pytest.raises(RuntimeError, match=match):
            mod.plan(env)


def test_coordinator_address_needs_hosts():
    for mod in (multihost, ref_multihost):
        with pytest.raises(RuntimeError):
            mod.coordinator_address({})


def test_initialize_is_a_noop_on_one_host():
    assert multihost.initialize({}, device="cpu", local_ranks=1) == \
        {"multihost": False, "num_processes": 1, "process_id": 0}
    assert not dist.is_initialized()
