"""Validation-Job entry point for the port — the counterpart of
``tpu_cluster/workloads/validate.py``:

    python -m tpu_cluster_torch.workloads.validate --mode=<mode> [--device cpu]

Modes, as the reference's:

  device-query  device enumeration                 (nvidia-smi analog)
  vector-add    an elementwise add on one card     (cuda-vector-add analog)
  matmul        bf16 matmul throughput             (compute smoke)
  psum          collective matrix over the ranks   (NCCL all-reduce test)
  burnin        sharded train step over the process group; loss
                decreases
  suite         all of the above (except burnin)

Multi-host Jobs run the same modes over one group of every card of every
host: when the Indexed-Job env (TPU_WORKER_HOSTNAMES ...) names more than
one host, each pod starts one rank per local card (``--psum-devices N``
ranks; 0 means every card, or 1 on the CPU), and each rank joins the
Job's group through ``multihost.initialize`` and runs the mode; the pod
prints its first rank's document. On one host, ``psum`` (and
``suite``'s psum) runs one rank per device likewise, over a group of the
host's own ranks (``collectives.run_ranks``). ``burnin`` in a group of
more than one rank trains on a ``burnin.default_mesh_shape`` mesh.

Runs on the card unless ``--device cpu`` is given; without a card it
exits non-zero. Output: one JSON document on stdout with the reference's
keys; exit code 0 iff every check passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _expected_devices(override: int) -> int:
    """Device count the Job was allocated: --expect-devices flag, else the
    TPU_DEVICE_COUNT env the device plugin's Allocate response injects,
    else 1."""
    if override > 0:
        return override
    return int(os.environ.get("TPU_DEVICE_COUNT", "1") or "1")


def _matrix(psum_devices: int, dev) -> dict:
    """The collective matrix on the Job's group, or on ``psum_devices``
    ranks of this host (0: every card, or 1 on the CPU)."""
    import torch

    from . import collectives

    n = psum_devices or (torch.cuda.device_count() if dev.type == "cuda"
                         else 1)
    return collectives.run_ranks(n, collectives.collective_matrix, n,
                                 device=dev)


def run(mode: str, matmul_dim: int = 2048, psum_devices: int = 0,
        expect_devices: int = 0, device=None) -> dict:
    import torch
    import torch.distributed as dist

    from . import burnin, collectives, multihost

    dev = burnin.resolve_device(device)
    if multihost.plan()["multihost"] and not dist.is_initialized():
        # one rank per local card, each joining the Job's group
        local = psum_devices or (torch.cuda.device_count()
                                 if dev.type == "cuda" else 1)
        if local > 1:
            return collectives.run_ranks(
                local, _checks, mode, matmul_dim, expect_devices,
                device=dev, join=multihost.join_rank)
        multihost.initialize(device=dev, local_ranks=1)
    return _checks(mode, matmul_dim, expect_devices, device=dev,
                   psum_devices=psum_devices)


def _checks(mode: str, matmul_dim: int, expect_devices: int,
            device=None, psum_devices: int = 0) -> dict:
    """``mode``'s checks in this process, on the group it has joined (a
    multi-host Job's) or on none."""
    from . import burnin, collectives, multihost, smoke

    dev = burnin.resolve_device(device)
    bootstrap = multihost.plan()
    if bootstrap["multihost"]:
        bootstrap.update(multihost.position(bootstrap))
    result: dict = {"mode": mode, "bootstrap": bootstrap}
    if mode == "device-query":
        rep = smoke.device_report(dev)
        result.update(rep)
        expected = _expected_devices(expect_devices)
        result["expected_devices"] = expected
        # a partially-initialized node (dead card) must FAIL, not pass
        # with fewer devices
        result["ok"] = rep["local_device_count"] == expected
        if bootstrap["multihost"]:
            # the assembled Job: every worker's devices must be counted,
            # or a missing or half-joined host passes unnoticed; each
            # host's first rank counts the host's cards
            want_global = expected * bootstrap["num_processes"]
            have = collectives.global_device_count(
                rep["local_device_count"] if bootstrap["local_rank"] == 0
                else 0, dev)
            result["expected_global_devices"] = want_global
            result["global_device_count"] = have
            result["ok"] = result["ok"] and have == want_global
    elif mode == "vector-add":
        result.update(smoke.vector_add(device=dev))
    elif mode == "matmul":
        result.update(smoke.matmul(matmul_dim, matmul_dim, matmul_dim,
                                   device=dev))
    elif mode == "psum":
        if bootstrap["multihost"]:
            # the cross-host all-reduce over every rank, plus the full
            # collective matrix over the Job's group
            gp = collectives.global_psum_check(device=dev)
            result.update(collectives.collective_matrix(device=dev))
            result["global_psum"] = gp
            result["ok"] = bool(result["ok"]) and gp["ok"]
        else:
            result.update(_matrix(psum_devices, dev))
    elif mode == "burnin":
        # the sharded step over the group (mesh (1, 1) without one)
        result.update(burnin.run(device=dev))
    elif mode == "suite":
        result.update(smoke.run_suite(matmul_dim=matmul_dim, device=dev))
        result["psum"] = _matrix(psum_devices, dev)
        result["ok"] = result["ok"] and result["psum"]["ok"]
    else:
        raise SystemExit(f"unknown --mode={mode}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_cluster_torch.workloads.validate")
    ap.add_argument("--mode", default="suite",
                    choices=["device-query", "vector-add", "matmul", "psum",
                             "burnin", "suite"])
    ap.add_argument("--matmul-dim", type=int, default=2048)
    ap.add_argument("--psum-devices", type=int, default=0,
                    help="ranks on this host, one a device (0 = every "
                         "card, or 1 on the CPU)")
    ap.add_argument("--expect-devices", type=int, default=0,
                    help="device-query: required local device count "
                         "(0 = TPU_DEVICE_COUNT env from Allocate, else 1)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to run (default: the card)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    if args.device == "cuda" and not torch.cuda.is_available():
        print("validate: no CUDA device; pass --device cpu to run on the "
              "CPU", file=sys.stderr)
        return 2
    # The whole run is one duty-cycle + tensorcore measurement window, so
    # the published gauges carry the run's measured utilization.
    from . import runtime_metrics
    had_group = dist.is_initialized()
    try:
        with runtime_metrics.duty_cycle_window(), \
                runtime_metrics.tensorcore_window():
            result = run(args.mode, args.matmul_dim, args.psum_devices,
                         args.expect_devices, args.device)
            written = runtime_metrics.write(runtime_metrics.resolved_path())
    finally:
        if dist.is_initialized() and not had_group:
            dist.destroy_process_group()  # joined by multihost.initialize
    if written:
        result["metrics_file"] = written
    print(json.dumps(result, indent=2))
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
