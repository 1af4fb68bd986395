"""Multi-host bootstrap plumbing for the port's Jobs: the counterpart of
``tpu_cluster/workloads/multihost.py``, over ``torch.distributed``.

The env contract is the reference's unchanged; the port's Job renderer
(``tpu_cluster_torch/render/jobs.py``) injects it as the reference's does:

  TPU_WORKER_ID        index of this pod within the Job (0..N-1)
  JOB_COMPLETION_INDEX the Indexed Job's own index, used when
                       TPU_WORKER_ID is absent
  TPU_WORKER_HOSTNAMES comma-separated pod DNS names (headless Service)
  TPU_COORDINATOR_PORT coordinator port (default 8476)

Where the reference calls ``jax.distributed.initialize``, the port joins a
``torch.distributed`` process group with one rank per card of every pod:
NCCL when the pod runs on its cards, gloo on the CPU, rendezvous over TCP
at the first host's coordinator port. A pod with several cards starts one
rank process per card (``collectives.run_ranks`` with :func:`join_rank`);
rank = host index x cards per host + local index, so the group spans
every card of every host, as the reference's global mesh spans every
chip.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

DEFAULT_COORDINATOR_PORT = 8476


def bootstrap_env(worker_id: int, hostnames: list, port: int = DEFAULT_COORDINATOR_PORT) -> Dict[str, str]:
    """The env block a multi-host Job manifest injects per pod (rendered by
    deploy/jobs; mirrored here for tests)."""
    return {
        "TPU_WORKER_ID": str(worker_id),
        "TPU_WORKER_HOSTNAMES": ",".join(hostnames),
        "TPU_COORDINATOR_PORT": str(port),
    }


def coordinator_address(env: Optional[Dict[str, str]] = None) -> str:
    env = dict(os.environ if env is None else env)
    hosts = env.get("TPU_WORKER_HOSTNAMES", "").split(",")
    if not hosts or not hosts[0]:
        raise RuntimeError("TPU_WORKER_HOSTNAMES not set; not a multi-host Job?")
    port = env.get("TPU_COORDINATOR_PORT", str(DEFAULT_COORDINATOR_PORT))
    return f"{hosts[0]}:{port}"


def plan(env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Resolve the process-group arguments without side effects
    (testable clusterless)."""
    env = dict(os.environ if env is None else env)
    if "TPU_WORKER_ID" not in env and "JOB_COMPLETION_INDEX" in env:
        env["TPU_WORKER_ID"] = env["JOB_COMPLETION_INDEX"]
    hosts = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    if len(hosts) <= 1:
        # one host means no cross-host bootstrap
        return {"multihost": False, "num_processes": 1, "process_id": 0}
    if "TPU_WORKER_ID" not in env:
        raise RuntimeError(
            "TPU_WORKER_HOSTNAMES is set but neither TPU_WORKER_ID nor "
            "JOB_COMPLETION_INDEX is — is the Job missing "
            "completionMode: Indexed?"
        )
    return {
        "multihost": True,
        "coordinator_address": coordinator_address(env),
        "num_processes": len(hosts),
        "process_id": int(env["TPU_WORKER_ID"]),
    }


def initialize(env: Optional[Dict[str, str]] = None, device: Any = None,
               *, local_ranks: int, local_rank: int = 0) -> Dict[str, Any]:
    """Join the Job's process group per the resolved plan as local rank
    ``local_rank`` of the ``local_ranks`` this host starts (every one of
    them must call this): global rank = host index x ``local_ranks`` +
    ``local_rank`` of hosts x ``local_ranks``, on card ``local_rank``.
    NCCL for a CUDA ``device`` (``None`` means the card), gloo for the
    CPU. A no-op for single-host Jobs. Returns the plan, and for a joined
    group the rank's place in it."""
    p = plan(env)
    if p["multihost"]:
        import torch
        import torch.distributed as dist

        dev = torch.device("cuda" if device is None else device)
        if not 0 <= local_rank < local_ranks:
            raise ValueError(f"local rank {local_rank} of {local_ranks}")
        if dev.type == "cuda":
            torch.cuda.set_device(local_rank)
        rank = p["process_id"] * local_ranks + local_rank
        world = p["num_processes"] * local_ranks
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{p['coordinator_address']}",
            rank=rank, world_size=world)
        p = {**p, **position(p)}
    return p


def position(p: Dict[str, Any]) -> Dict[str, int]:
    """This rank's place in the joined group of a multi-host plan ``p``:
    ``rank``, ``world_size`` and ``local_rank`` (its index among its
    host's ranks)."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    return {"rank": rank, "world_size": world,
            "local_rank": rank % (world // p["num_processes"])}


def join_rank(local_rank: int, local_ranks: int, device: Any) -> None:
    """Join as local rank ``local_rank`` of ``local_ranks`` on this host,
    under this process's Indexed-Job env: the join of one rank process
    that ``collectives.run_ranks`` starts for each card of a pod."""
    initialize(device=device, local_rank=local_rank, local_ranks=local_ranks)
