"""The accelerator catalogue: the per-card constants the port's gauges and
checks need, and the host layouts its labeler and Job renderer read.

The reference's ``tpu_cluster/topology.py`` models TPU hosts: chip grids,
aligned request sizes, sub-mesh allocation. The grids and the aligned
sub-mesh policy serve the native TPU device plugin; the cards of a GPU
host sit on one NVLink switch domain, all to all, so neither is copied
here. What the port needs of it is the per-chip catalogue: HBM capacity
(the ``catalogue`` rung of the HBM gauge
ladder in :mod:`.workloads.runtime_metrics`), the dense bf16 peak (the
tensorcore-utilization gauge, MFU ceilings in ``chip_smoke.py``) and the
interconnect rate (``collectives.ici_roofline``), resolved from a CUDA
device name or from the ``TPU_ACCELERATOR_TYPE`` override the reference
honours; and the per-host configuration (:class:`HostType`: which card,
how many a host holds, how NVLink joins them), which the node labels
(:mod:`.discovery.labels`), the readiness condition and the validation
Jobs (:mod:`.render.jobs`) are built from.

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
    # the model's name as nvidia-smi and NVML report it
    product: str = ""


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
    product="NVIDIA H100 80GB HBM3",
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


@dataclass(frozen=True)
class HostType:
    """One per-host configuration: the counterpart of the reference's
    catalogue entries (``chips_per_host``, ``label_topology``). A GPU host
    is one host: the layouts below hold no multi-host slice."""

    name: str                 # the labeler's --accelerator, e.g. "h100-sxm5-80gb-8"
    card: AcceleratorType
    cards_per_host: int

    def label_topology(self) -> str:
        """NVLink domains x cards a domain on the host: every registered
        layout is one switch domain (or a lone card), so "1x8" for the
        eight-card board and "1x1" for one card."""
        return f"1x{self.cards_per_host}"


HOST_TYPES: Dict[str, HostType] = {}


def _register_host(t: HostType) -> HostType:
    HOST_TYPES[t.name] = t
    return t


# One H100 SXM5 card on its host, no NVLink peer (a one-card machine, as
# nvidia-smi lists one "NVIDIA H100 80GB HBM3").
H100_SXM5_80GB_1 = _register_host(HostType(
    name="h100-sxm5-80gb-1", card=H100_SXM5_80GB, cards_per_host=1))

# The HGX H100 8-GPU board (NVIDIA HGX H100 and DGX H100 data sheets):
# eight H100 SXM5 cards on four third-generation NVSwitch chips, every
# card at its full 900 GB/s NVLink rate to every other: one switch domain.
H100_SXM5_80GB_8 = _register_host(HostType(
    name="h100-sxm5-80gb-8", card=H100_SXM5_80GB, cards_per_host=8))


def get_host(name: str) -> HostType:
    """The host layout ``name`` (folded as :func:`get` folds)."""
    canonical = canonical_name(name)
    try:
        return HOST_TYPES[canonical]
    except KeyError:
        raise KeyError(
            f"unknown host type {name!r}; "
            f"known: {sorted(HOST_TYPES)}") from None
