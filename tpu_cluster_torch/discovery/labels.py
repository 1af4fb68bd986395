"""Node-label computation: the counterpart of
``tpu_cluster/discovery/labels.py``, under ``nvidia.com/gpu.``.

Each of the reference's six keys has a counterpart. Where NVIDIA's
gpu-feature-discovery publishes a key of the same meaning, it is used
with that tool's value format: ``present``, ``product`` (the card's name
with blanks as dashes, for the reference's accelerator type), ``family``
(the architecture, for its generation) and ``count``. ``topology``
(:meth:`HostType.label_topology`) and ``nvlink-domain`` (for its ICI
domain) have no such key and are the port's own.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import topology
from .devices import GpuDevice

PRESENT = "nvidia.com/gpu.present"
PRODUCT = "nvidia.com/gpu.product"
FAMILY = "nvidia.com/gpu.family"
TOPOLOGY = "nvidia.com/gpu.topology"
COUNT = "nvidia.com/gpu.count"
NVLINK_DOMAIN = "nvidia.com/gpu.nvlink-domain"

ALL_KEYS = (PRESENT, PRODUCT, FAMILY, TOPOLOGY, COUNT, NVLINK_DOMAIN)


def compute_labels(accelerator: str, devices: List[GpuDevice],
                   node_name: str = "") -> Dict[str, Optional[str]]:
    """Labels for a node of the host layout ``accelerator``. When no card
    is found, every key except ``present`` maps to None, which the
    strategic-merge patch serialises to null, deleting the stale key."""
    if not devices:
        out: Dict[str, Optional[str]] = {k: None for k in ALL_KEYS}
        out[PRESENT] = "false"
        return out
    host = topology.get_host(accelerator)
    return {
        PRESENT: "true",
        PRODUCT: host.card.product.replace(" ", "-"),
        FAMILY: host.card.generation,
        TOPOLOGY: host.label_topology(),
        COUNT: str(len(devices)),
        # the host's cards share one switch domain: the host is the domain
        NVLINK_DOMAIN: node_name or "local",
    }
