"""The accelerator catalogue, minimal: the per-card constants the port's
gauges and checks need, for the cards it knows.

The reference's ``tpu_cluster/topology.py`` models TPU hosts: chip grids,
aligned request sizes, sub-mesh allocation. None of that applies to a
card, and none of it is copied here. What the port needs of it is the
per-chip catalogue: HBM capacity (the ``catalogue`` rung of the HBM gauge
ladder in :mod:`.workloads.runtime_metrics`), the dense bf16 peak (the
tensorcore-utilization gauge, MFU ceilings in ``chip_smoke.py``) and the
interconnect rate (``collectives.ici_roofline``), resolved from a CUDA
device name or from the ``TPU_ACCELERATOR_TYPE`` override the reference
honours.

Every rate below is a data-sheet ceiling (NVIDIA's H100 SXM5 data sheet,
dense, no sparsity, at the card's full 700 W), never a measurement: a
measured rate is judged against it, never replaced by it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class AcceleratorType:
    """One card model's per-card constants."""

    name: str                 # catalogue key, e.g. "h100-sxm5-80gb"
    generation: str           # e.g. "hopper"
    hbm_gib_per_chip: int
    peak_bf16_tflops: float   # dense bf16 tensor-core rate, per card
    hbm_bytes_per_s: float    # memory bandwidth, per card
    # NVLink bandwidth per card, both directions summed (GB/s), the
    # counterpart of the reference's aggregate per-chip ICI rate
    link_gbytes_per_s: float
    # substrings of torch.cuda.get_device_name() that identify the model
    device_names: Tuple[str, ...] = ()


ACCELERATOR_TYPES: Dict[str, AcceleratorType] = {}


def _register(t: AcceleratorType) -> AcceleratorType:
    ACCELERATOR_TYPES[t.name] = t
    return t


H100_SXM5_80GB = _register(AcceleratorType(
    name="h100-sxm5-80gb", generation="hopper", hbm_gib_per_chip=80,
    peak_bf16_tflops=989.0, hbm_bytes_per_s=3.35e12,
    link_gbytes_per_s=900.0,
    # the SXM5 part reports "NVIDIA H100 80GB HBM3"; the PCIe and NVL
    # parts (other peaks) report "H100 PCIe" and "H100 NVL"
    device_names=("H100 80GB HBM3", "H100 SXM"),
))


def from_device_name(device_name: str) -> Optional[AcceleratorType]:
    """The catalogue entry for a ``torch.cuda.get_device_name()`` string,
    or None when the card is not in the catalogue."""
    for acc in ACCELERATOR_TYPES.values():
        if any(marker in device_name for marker in acc.device_names):
            return acc
    return None


def canonical_name(name: str) -> str:
    """Catalogue spelling of an accelerator-type string: lower case, no
    surrounding blanks. Unknown names pass through."""
    return name.strip().lower()


def get(name: str) -> AcceleratorType:
    canonical = canonical_name(name)
    try:
        return ACCELERATOR_TYPES[canonical]
    except KeyError:
        # the error names the string the caller passed: they grep their
        # config for that, not for the folded spelling
        raise KeyError(
            f"unknown accelerator type {name!r}; "
            f"known: {sorted(ACCELERATOR_TYPES)}") from None
