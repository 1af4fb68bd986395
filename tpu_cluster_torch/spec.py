"""The spec the port's Job renderer reads (:mod:`.render.jobs`): which host
layout, where the Jobs go, what they request and run. The reference's
``tpu_cluster/spec.py`` also carries the cluster's bootstrap; the Job
renderer reads none of it, so none of it is here."""

from __future__ import annotations

from dataclasses import dataclass

from . import topology

DEFAULT_NAMESPACE = "gpu-system"
DEFAULT_RESOURCE = "nvidia.com/gpu"
DEFAULT_IMAGE = "ghcr.io/tpu-native/tpu-stack-torch:0.1.0"


class SpecError(ValueError):
    pass


@dataclass
class GpuSpec:
    accelerator: str = topology.H100_SXM5_80GB_8.name
    namespace: str = DEFAULT_NAMESPACE
    resource_name: str = DEFAULT_RESOURCE
    image: str = DEFAULT_IMAGE

    def validate(self) -> "GpuSpec":
        """Check every field; fold the accelerator to its catalogue
        spelling, so every rendered object carries one."""
        try:
            topology.get_host(self.accelerator)
        except KeyError as exc:
            raise SpecError(exc.args[0]) from None
        self.accelerator = topology.canonical_name(self.accelerator)
        for field in ("namespace", "resource_name", "image"):
            if not getattr(self, field):
                raise SpecError(f"{field} must be non-empty")
        return self

    @property
    def host_type(self) -> topology.HostType:
        return topology.get_host(self.accelerator)
