"""Card device-node discovery: the counterpart of
``tpu_cluster/discovery/devices.py``.

The NVIDIA kernel module gives each card a node ``/dev/nvidia<N>``; beside them
sit control nodes that are no card (``nvidiactl``, ``nvidia-uvm``,
``nvidia-uvm-tools``, ``nvidia-modeset``, the ``nvidia-caps/``
directory). VFIO passthrough gives ``/dev/vfio/<group>``. Tests run
against a fake device tree (:func:`make_fake_tree`), a directory with the
same entries.
"""

from __future__ import annotations

import glob as _glob
import os
import re
from dataclasses import dataclass
from typing import List

# the nodes the kernel module creates beside the cards' own
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools",
                 "nvidia-modeset")
CAPS_DIR = "nvidia-caps"


@dataclass(frozen=True)
class GpuDevice:
    index: int
    path: str      # e.g. /dev/nvidia3
    vfio: bool = False


# Card index = trailing digits of the basename, whatever the prefix, as
# the reference's rule: a basename without trailing digits (the control
# nodes) is not a card.
_INDEX_RE = re.compile(r"(\d+)$")


def discover(device_glob: str = "/dev/nvidia[0-9]*",
             devfs_root: str = "") -> List[GpuDevice]:
    """Enumerate card device nodes matching ``device_glob``.

    ``devfs_root`` re-roots the glob for fake trees (tests): with
    devfs_root=/tmp/x, /dev/nvidia* is looked up at /tmp/x/dev/nvidia*.
    """
    pattern = device_glob
    if devfs_root:
        pattern = os.path.join(devfs_root, device_glob.lstrip("/"))
    devices = []
    for path in sorted(_glob.glob(pattern)):
        m = _INDEX_RE.search(os.path.basename(path))
        if not m:
            continue
        devices.append(GpuDevice(index=int(m.group(1)), path=path))
    return sorted(devices, key=lambda d: d.index)


def discover_vfio(devfs_root: str = "") -> List[GpuDevice]:
    """VFIO-passthrough enumeration: /dev/vfio/<group-number> entries."""
    root = os.path.join(devfs_root, "dev/vfio") if devfs_root else "/dev/vfio"
    devices = []
    for path in sorted(_glob.glob(os.path.join(root, "*"))):
        name = os.path.basename(path)
        if name.isdigit():
            devices.append(GpuDevice(index=int(name), path=path, vfio=True))
    return sorted(devices, key=lambda d: d.index)


def make_fake_tree(root: str, n: int, vfio: bool = False) -> List[str]:
    """Create a fake device tree with n cards under ``root`` (for tests);
    an ``nvidia*`` tree also gets the control nodes, which are no card. Returns
    the cards' paths."""
    sub = "dev/vfio" if vfio else "dev"
    d = os.path.join(root, sub)
    os.makedirs(d, exist_ok=True)
    if not vfio:
        for name in CONTROL_NODES:
            open(os.path.join(d, name), "w", encoding="utf-8").close()
        caps = os.path.join(d, CAPS_DIR)
        os.makedirs(caps, exist_ok=True)
        for name in ("nvidia-cap1", "nvidia-cap2"):
            open(os.path.join(caps, name), "w", encoding="utf-8").close()
    paths = []
    for i in range(n):
        p = os.path.join(d, str(i) if vfio else f"nvidia{i}")
        with open(p, "w", encoding="utf-8"):
            pass
        paths.append(p)
    return paths
