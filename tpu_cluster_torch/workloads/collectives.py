"""Collective validation over the process group — the NCCL all-reduce test
analog, the port's counterpart of ``tpu_cluster/workloads/collectives.py``.

Where the reference lays one process's chips out on a JAX mesh and lets
XLA emit the collective, torch runs one rank per device: a process group
of ``world_size`` ranks, NCCL between cards and gloo on the CPU. The
reference's collectives map one to one: ``psum`` -> ``all_reduce``,
``all_gather`` -> ``all_gather_into_tensor``, ``psum_scatter`` ->
``reduce_scatter_tensor``, ``ppermute`` -> a ring of ``batch_isend_irecv``.

Every check runs on the current default process group, or, when none is
up, on a trivial one of size 1 for the duration of the call (a
collective over one rank is the identity, and still goes through the
backend). :func:`run_ranks` starts ``n`` ranks on one host, each in a
process of its own over a local TCP rendezvous, runs a check on all of
them and returns rank 0's result — the counterpart of the reference's
all-local-chips mesh (and, on the CPU with gloo, of its virtual 8-device
test mesh).
"""

from __future__ import annotations

import contextlib
import functools
import os
import queue
import time
import traceback
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from . import runtime_metrics, timing
from .burnin import DeviceLike, resolve_device

# The single-tensor collectives took new names in recent torch releases
# (the old ones warn); same signatures.
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# One rank may wait this long for the others in run_ranks.
RANK_TIMEOUT_S = 600.0


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


@contextlib.contextmanager
def process_group(device: DeviceLike = None
                  ) -> Iterator[Tuple[int, int, torch.device]]:
    """Yields ``(rank, world_size, device)`` on the default process group;
    when none is up, on a group of size 1 (NCCL for a card, gloo for the
    CPU) that is torn down on exit."""
    dev = resolve_device(device)
    if dist.is_initialized():
        yield dist.get_rank(), dist.get_world_size(), dev
        return
    dist.init_process_group(_backend(dev), store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        yield 0, 1, dev
    finally:
        dist.destroy_process_group()


def _check_size(n_devices: int, world: int) -> None:
    """``n_devices`` 0 means the whole group; any other value must be its
    size (one rank a device)."""
    if n_devices and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, the process group "
                         f"has {world} ranks (one a device)")


def _sync(x: torch.Tensor) -> None:
    """Wait for ``x`` by fetching one element to the host."""
    x.reshape(-1)[:1].cpu()


def _every_rank(flag: bool, device: torch.device) -> bool:
    """True iff ``flag`` holds on every rank (an all-reduce MIN)."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def psum_check(n_devices: int = 0, elems_per_device: int = 1 << 16,
               device: DeviceLike = None) -> Dict[str, Any]:
    """All-reduce correctness: each rank contributes its index; the sum
    must be sum(range(n)) everywhere, on every rank. One more repetition
    runs as a device-execution region (synced by a one-element host
    fetch), so a psum validation Job publishes a measured duty cycle."""
    with process_group(device) as (rank, n, dev):
        _check_size(n_devices, n)
        x = torch.full((elems_per_device,), float(rank), device=dev)
        out = x.clone()
        dist.all_reduce(out)
        expect = float(n * (n - 1) / 2)
        ok = _every_rank(bool((out == expect).all()), dev)
        with runtime_metrics.device_busy():
            again = x.clone()
            dist.all_reduce(again)
            _sync(again)
    return {"check": "psum", "devices": n, "expected": expect, "ok": ok}


def global_psum_check(elems: int = 0, device: DeviceLike = None
                      ) -> Dict[str, Any]:
    """All-reduce across every process of the group — the cross-host half
    of the acceptance check (the reference's multi-controller psum):
    ``arange(elems or n)`` is sharded over the ranks (rank r holds
    elements r, r + n, ...), each rank sums its shard, and the all-reduced
    total must be the sum of the whole range on every rank."""
    with process_group(device) as (rank, n, dev):
        size = elems or n
        shard = torch.arange(size, dtype=torch.float32, device=dev)[rank::n]
        total_t = shard.sum().reshape(1)
        dist.all_reduce(total_t)
        total = float(total_t.item())
    expect = float(size * (size - 1) / 2)
    return {
        "check": "global_psum",
        "devices": n,
        "processes": n,
        "process_index": rank,
        "expected": expect,
        "total": total,
        "ok": total == expect,
    }


def global_device_count(local_count: int, device: DeviceLike = None) -> int:
    """The sum of every process's local device count over the group: a
    worker that did not join, or joined with fewer cards, shows here."""
    with process_group(device) as (_, _, dev):
        t = torch.tensor([local_count], dtype=torch.int64, device=dev)
        dist.all_reduce(t)
        return int(t.item())


def allreduce_bandwidth(n_devices: int = 0, mib: int = 64, iters: int = 10,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """Measured all-reduce bus bandwidth per device (nccl-tests busbw
    analog): busbw = 2*(n-1)/n * bytes / time, over a dispatch loop of
    ``iters`` all-reduces ending in a one-element fetch."""
    with process_group(device) as (_, n, dev):
        _check_size(n_devices, n)
        per_dev = mib * 1024 * 1024 // 4
        x = torch.ones(per_dev, device=dev)
        dist.all_reduce(x)
        _sync(x)
        t0 = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(x)
        _sync(x)
        dt = time.perf_counter() - t0
    bytes_per_iter = per_dev * 4
    busbw = (2 * (n - 1) / max(n, 1)) * bytes_per_iter * iters / dt
    return {"check": "allreduce_bw", "devices": n, "mib": mib,
            "seconds": dt, "busbw_gib_s": busbw / 2**30, "ok": True}


def bus_bandwidth(op: str, n_devices: int = 0, mib: float = 64,
                  iters: int = 8, reps: int = 3,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """Timed ``op`` bus bandwidth (nccl-tests busbw convention): ``iters``
    collectives chained through a data-dependent carry, a one-element
    host fetch as the sync, and the shared two-point estimator
    (:mod:`.timing`) cancelling the fetch and dispatch constant.

    busbw — the algorithm-independent wire rate per device:
      all_reduce: 2*(n-1)/n * shard_bytes / t
      all_gather:   (n-1)/n * gathered_bytes / t  =  (n-1) * shard_bytes / t

    The estimator is fed bytes pre-scaled so its ``tflops`` slot reads in
    GiB/s; the min/median/max spread rides along in the same unit. With
    one rank both formulas give 0.
    """
    if op not in ("all_reduce", "all_gather"):
        raise ValueError(f"unknown collective op: {op}")
    with process_group(device) as (_, n, dev):
        _check_size(n_devices, n)
        per_dev = max(1, int(mib * 1024 * 1024) // 4)
        x = torch.ones(per_dev, device=dev)
        gathered = torch.empty(n * per_dev, device=dev)

        def step(c: torch.Tensor) -> torch.Tensor:
            if op == "all_reduce":
                dist.all_reduce(c)
                # rescale so the chained carry stays O(1), not n^iters
                return c.mul_(1.0 / n)
            _all_gather(gathered, c)
            return gathered.view(n, per_dev).mean(0)  # reads every row

        def run_once(length: int) -> float:
            c = x.clone()
            t0 = time.perf_counter()
            for _ in range(length):
                c = step(c)
            _sync(c)
            return time.perf_counter() - t0

        run_once(iters), run_once(3 * iters)  # excluded warm-up pair
        pairs = [(run_once(iters), run_once(3 * iters)) for _ in range(reps)]
    shard_bytes = per_dev * 4
    if op == "all_reduce":
        bus_bytes = 2 * (n - 1) / max(n, 1) * shard_bytes
    else:
        bus_bytes = (n - 1) * shard_bytes
    # Pre-scale so paired_two_point's /1e12 yields GiB: "tflops" IS GiB/s.
    gib = bus_bytes * 1e12 / 2**30
    est = timing.paired_two_point(pairs, gib * 2 * iters, gib * 3 * iters)
    out: Dict[str, Any] = {
        "check": f"{op}_busbw", "op": op, "devices": n,
        "payload_mib": mib, "iters": iters, "reps": reps,
        "busbw_gib_s": round(est["tflops"], 2),
        "estimator": est["estimator"],
    }
    if "spread" in est:
        out["busbw_spread"] = est["spread"]
    if "note" in est:
        out["note"] = est["note"]
    return out


def ici_roofline(n_devices: int = 0, mib: float = 64, iters: int = 8,
                 reps: int = 3, device: DeviceLike = None) -> Dict[str, Any]:
    """All-reduce + all-gather busbw at gradient-sized payloads, so a
    data-parallel scaling loss is attributable (compute-bound or
    collective-bound). On a card the catalogue knows, ``link_util`` is
    the measured all-reduce busbw over the data sheet's NVLink rate (both
    directions summed, as the reference's per-chip ICI rate is), under the
    reference's key names."""
    with process_group(device) as (_, n, dev):
        _check_size(n_devices, n)
        out: Dict[str, Any] = {"check": "ici_roofline", "devices": n,
                               "payload_mib": mib}
        for op in ("all_reduce", "all_gather"):
            out[op] = bus_bandwidth(op, n_devices=n, mib=mib, iters=iters,
                                    reps=reps, device=dev)
        if dev.type == "cuda":
            from .. import topology

            acc = topology.from_device_name(torch.cuda.get_device_name(dev))
            if acc is not None and acc.link_gbytes_per_s:
                peak_gib_s = acc.link_gbytes_per_s * 1e9 / 2**30
                out["ici_peak_gib_s"] = round(peak_gib_s, 1)
                out["link_util"] = round(
                    out["all_reduce"]["busbw_gib_s"] / peak_gib_s, 3)
    return out


def collective_matrix(n_devices: int = 0, device: DeviceLike = None
                      ) -> Dict[str, Any]:
    """Exercise the collective family the stack must support: all_reduce,
    all_gather, reduce_scatter and a ring permutation, each checked on
    every rank."""
    with process_group(device) as (rank, n, dev):
        _check_size(n_devices, n)
        results: Dict[str, Any] = {"devices": n}

        mine = torch.tensor([float(rank)], device=dev)
        gathered = torch.empty(n, device=dev)
        _all_gather(gathered, mine)
        results["all_gather_ok"] = _every_rank(
            torch.equal(gathered.cpu(), torch.arange(n, dtype=torch.float32)),
            dev)

        scattered = torch.empty(1, device=dev)
        _reduce_scatter(scattered, torch.ones(n, device=dev))
        results["reduce_scatter_ok"] = _every_rank(
            scattered.item() == float(n), dev)

        # rank i sends its index to i + 1 and receives i - 1's
        received = torch.empty(1, device=dev)
        if n == 1:
            received.copy_(mine)  # the one-rank ring is the identity
        else:
            ops = [dist.P2POp(dist.isend, mine, (rank + 1) % n),
                   dist.P2POp(dist.irecv, received, (rank - 1) % n)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        results["ppermute_ok"] = _every_rank(
            received.item() == float((rank - 1) % n), dev)

        results["psum_ok"] = psum_check(n, device=dev)["ok"]
    results["ok"] = all(v for k, v in results.items() if k.endswith("_ok"))
    return results


def _join_store(port: int, rank: int, n: int, device: torch.device) -> None:
    """Join a group of ``n`` ranks through the TCP store that
    :func:`run_ranks`' caller hosts on ``port``."""
    store = dist.TCPStore("127.0.0.1", port, is_master=False)
    dist.init_process_group(_backend(device), store=store, rank=rank,
                            world_size=n)


def _rank_main(rank: int, n: int, join: Callable[..., None],
               device_type: str, fn: Callable[..., Dict[str, Any]],
               args: tuple, results) -> None:
    """One rank of :func:`run_ranks`: on its card, join the group with
    ``join(rank, n, device)``, run ``fn`` in a duty-cycle window, report
    ``(rank, status, result or traceback, busy seconds)``."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        else:
            # n ranks share this host's cores
            torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // n))
        dev = torch.device(device_type)
        join(rank, n, dev)
        try:
            with runtime_metrics.duty_cycle_window() as sampler:
                out = fn(*args, device=dev)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out, sampler.total_busy_s))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc(), 0.0))


def run_ranks(n: int, fn: Callable[..., Dict[str, Any]], *args: Any,
              device: DeviceLike = None,
              join: Optional[Callable[..., None]] = None) -> Dict[str, Any]:
    """``fn(*args, device=...)`` on ``n`` ranks of one host, one device
    each (cards 0..n-1, or n gloo ranks on the CPU), and rank 0's result.

    With ``n <= 1`` and no ``join``, or inside a process group that is
    already up, ``fn`` runs here. Otherwise each rank is a process of its
    own (``spawn``) on card ``rank``, which joins its group with
    ``join(rank, n, device)``: by default a group of these ``n`` ranks,
    over a TCP store this process hosts on a free local port; a
    multi-host Job passes ``multihost.join_rank``, so that each rank
    joins the Job's group. The ranks' device-busy seconds are reported to
    this process's duty-cycle window. A rank that fails raises here with
    its traceback; ranks that do not finish within ``RANK_TIMEOUT_S`` are
    killed.
    """
    dev = resolve_device(device)
    if (n <= 1 and join is None) or dist.is_initialized():
        return fn(*args, device=dev)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"requested {n} devices, have "
                         f"{torch.cuda.device_count()}")
    import torch.multiprocessing as mp

    store = None
    if join is None:
        store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                              wait_for_workers=False)
        join = functools.partial(_join_store, store.port)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, join, dev.type, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got: Dict[int, Tuple[Dict[str, Any], float]] = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(got) < n:
            try:
                rank, status, out, busy = results.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise RuntimeError(
                    f"{n - len(got)} of {n} ranks did not finish within "
                    f"{RANK_TIMEOUT_S:g} s") from None
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
            got[rank] = (out, busy)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    out, busy = got[0]
    runtime_metrics.add_busy(busy)
    return out


if __name__ == "__main__":
    import json
    print(json.dumps(collective_matrix(), indent=2))
