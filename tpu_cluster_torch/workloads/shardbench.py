"""Sharded train-step bench arms: the port's counterpart of
``tpu_cluster/workloads/shardbench.py``, with its names. It plans and
measures three arms over ``burnin.make_mesh``:

  dp            pure data parallel, mesh (n, 1), global batch scaled by n;
  mp            the default DP x TP factorisation (``default_mesh_shape``),
                the Megatron layout of ``burnin.param_specs``;
  long_context  the default mesh at seq 8192, batch 1 a data row,
                attention picked by ``burnin.select_attention``: on a card
                the flash kernels (K1, K2, K3) at H / tp heads.

Every arm runs ``burnin.timed_steps`` with its mesh: the two-point
estimator of the single-device entries, FLOPs of the global step
(``flops_scope`` "global"). One rank a device: ``run_arms`` measures over
the current process group (every rank calls it), over a one-rank group
when none is up, or over ``n_devices`` ranks it starts on this host
(``collectives.run_ranks``). The CLI
(``python -m tpu_cluster_torch.workloads.shardbench [--device cpu]``)
prints the arms and the collectives roofline as one JSON document.

Deviation: ``_TINY`` has 4 heads where the reference's has 2, so that
the default mesh's model axis of 4 splits whole heads (GSPMD reshards a
ragged split; the port raises instead).
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

from . import burnin, collectives


@dataclass(frozen=True)
class Arm:
    """One planned sharded measurement: a name, a mesh factorisation and a
    config whose global batch is already scaled to the mesh's data axis."""
    name: str
    mesh_shape: Tuple[int, int]
    cfg: burnin.BurninConfig
    steps: int
    reps: int


# Tiny geometry for runs without a card: the reference's, with heads,
# d_ff and vocab divisible by 4 so the model axis of default_mesh_shape
# always lands on whole shards.
_TINY = burnin.BurninConfig(vocab=128, d_model=64, d_ff=256, n_heads=4,
                            seq=32, batch=4)


def plan(n_devices: int, tiny: bool) -> List[Arm]:
    """The arm table for ``n_devices``, the reference's. ``tiny`` selects
    the small geometry; otherwise arms use the standard geometry (f32
    masters)."""
    dp_shape = (n_devices, 1)
    mixed = burnin.default_mesh_shape(n_devices)
    if tiny:
        base, steps, reps = _TINY, 4, 2
        long_cfg = replace(_TINY, seq=4 * _TINY.seq)
    else:
        base, steps, reps = burnin.standard_config(), 10, 5
        # s8192, b1 a data row; d_head 256 lets select_attention pick the
        # flash kernels on a card
        long_cfg = replace(base, seq=8192, batch=1)
    return [
        Arm("dp", dp_shape, replace(base, batch=base.batch * dp_shape[0]),
            steps, reps),
        Arm("mp", mixed, replace(base, batch=base.batch * mixed[0]),
            steps, reps),
        Arm("long_context", mixed,
            replace(long_cfg, batch=long_cfg.batch * mixed[0]), steps, reps),
    ]


def measure_arm(arm: Arm, platform: Optional[str] = None,
                device: burnin.DeviceLike = None) -> Dict[str, Any]:
    """Run one arm on this rank: attention by the crossover selector for
    ``platform`` (default: the device's type), the arm's mesh over the
    process group, ``burnin.timed_steps``' result annotated with the mesh
    and the attention mode that ran."""
    dev = burnin.resolve_device(device)
    att = burnin.select_attention(arm.cfg, platform or dev.type)
    cfg = replace(arm.cfg, attention=att)
    mesh = burnin.make_mesh(arm.mesh_shape, dev)
    out = burnin.timed_steps(cfg, steps=arm.steps, reps=arm.reps,
                             device=dev, mesh=mesh)
    out["mesh"] = {"data": arm.mesh_shape[0], "model": arm.mesh_shape[1]}
    out["attention"] = att
    return out


def run_arms(n_devices: Optional[int] = None, tiny: Optional[bool] = None,
             device: burnin.DeviceLike = None) -> Dict[str, Any]:
    """Measure every planned arm, with per-arm error isolation (one arm
    failing must not lose the others' numbers). ``n_devices`` defaults to
    the process group's size (1 without one); a count other than that
    starts as many ranks on this host when no group is up. ``tiny``
    defaults to the platform: the full geometry on a card, tiny on the
    CPU."""
    import torch.distributed as dist

    dev = burnin.resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = int(n_devices or world)
    if n != world:
        if dist.is_initialized():
            raise ValueError(f"requested {n} devices, the process group "
                             f"has {world} ranks (one a device)")
        return collectives.run_ranks(n, run_arms, n, tiny, device=dev)
    platform = dev.type
    if tiny is None:
        tiny = platform != "cuda"
    doc: Dict[str, Any] = {"check": "shardbench", "platform": platform,
                           "devices": n, "tiny": bool(tiny), "arms": {}}
    with collectives.process_group(dev) as (_, _, dev):
        for arm in plan(n, tiny):
            try:
                doc["arms"][arm.name] = measure_arm(arm, platform, dev)
            except Exception as exc:  # per-arm isolation
                doc["arms"][arm.name] = {
                    "mesh": {"data": arm.mesh_shape[0],
                             "model": arm.mesh_shape[1]},
                    "error": repr(exc)[:300],
                }
    return doc


def main(argv=None) -> Dict[str, Any]:
    """CLI doc: the sharded arms plus the collectives roofline that
    explains them (one rank moves nothing over a link: busbw 0)."""
    ap = argparse.ArgumentParser(prog="tpu_cluster_torch.workloads.shardbench")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to run (default: the card)")
    args = ap.parse_args(argv)
    doc = run_arms(device=args.device)
    tiny = doc["tiny"]
    try:
        doc["collectives"] = collectives.ici_roofline(
            mib=256 if not tiny else 1,
            iters=8 if not tiny else 2,
            reps=3 if not tiny else 2,
            device=args.device)
    except Exception as exc:
        doc["collectives"] = {"error": repr(exc)[:300]}
    return doc


if __name__ == "__main__":
    print(json.dumps(main(), indent=2))
