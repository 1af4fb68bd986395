"""The host around a run: where its process may run and where its threads
did, how busy the machine was, the card's clock and power, and the
collector's pauses. Read before the window opens and after it closes,
never inside it, and printed as notes beside the result; none of them is
a metric, and none changes where or how the run executes.
"""

from __future__ import annotations

import ctypes
import gc
import os
import re
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

PROC = Path("/proc")
PCI_DEVICES = Path("/sys/bus/pci/devices")
NVIDIA_DRIVER = Path("/sys/bus/pci/drivers/nvidia")
PCI_ADDRESS = re.compile(r"^[0-9a-f]{4,8}:[0-9a-f]{2}:[0-9a-f]{2}\.[0-7]$")
TICK_S = 1.0 / os.sysconf("SC_CLK_TCK")
# the busiest threads of the window a note names
TOP_THREADS = 6
NVML_CLOCK_SM = 1


def parse_cpulist(text: str) -> Set[int]:
    """CPUs of a kernel cpulist (``"0-31,64-95"``, ``"7"``); empty for an
    empty list."""
    cpus: Set[int] = set()
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def cpulist(cpus: Iterable[int]) -> str:
    """The cpulist spelling of ``cpus``: runs joined by ``-``."""
    out: List[str] = []
    run: List[int] = []
    for c in sorted(cpus):
        if run and c == run[-1] + 1:
            run.append(c)
            continue
        if run:
            out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
        run = [c]
    if run:
        out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
    return ",".join(out)


def card_address() -> Optional[str]:
    """The PCI address of the card the run's CUDA device 0 is, read
    without starting CUDA: the cards bound to the NVIDIA driver in bus
    order (CUDA's order among cards alike), the first that
    ``CUDA_VISIBLE_DEVICES`` names by index; None where there is none."""
    try:
        cards = sorted(p.name for p in NVIDIA_DRIVER.iterdir()
                       if PCI_ADDRESS.match(p.name))
    except OSError:
        return None
    index = _visible_index()
    return cards[index] if index < len(cards) else None


def _visible_index() -> int:
    """The index, among all cards, of CUDA's device 0."""
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    return int(first) if first.isdigit() else 0


def local_allowed(allowed: Set[int], local_text: Optional[str]) -> str:
    """The CPUs local to the card (``local_text``, its ``local_cpulist``)
    that the process is ``allowed``, or why there are none."""
    if local_text is None:
        return "none: the card's local_cpulist is unreadable"
    local = parse_cpulist(local_text)
    both = local & allowed
    if not both:
        return (f"none: the card's CPUs {cpulist(local) or '-'} share none "
                f"with the allowed {cpulist(allowed)}")
    return cpulist(both)


def placement() -> Dict[str, Any]:
    """Where the run may execute, as notes: the CPUs it is allowed, the
    card's PCI address, the CPUs local to the card and those of them it
    is allowed. The run stays where the scheduler puts it."""
    allowed = os.sched_getaffinity(0)
    address = card_address()
    text = None
    if address is not None:
        try:
            text = (PCI_DEVICES / address / "local_cpulist").read_text()
        except OSError:
            text = None
    return {"cpus_allowed": cpulist(allowed),
            "card_pci": address or "not found",
            "card_local_cpus": text.strip() if text is not None else "unread",
            "card_local_allowed": local_allowed(allowed, text)}


# ------------------------------------------------------------ readings


def _read(path: Path) -> Optional[str]:
    try:
        return path.read_text()
    except OSError:
        return None


def thread_stat(tid: int) -> Optional[Dict[str, Any]]:
    """One thread's name, CPU seconds, last CPU, migrations, run-queue
    wait and involuntary switches, each where ``/proc`` shows it."""
    task = PROC / "self" / "task" / str(tid)
    stat = _read(task / "stat")
    if stat is None:
        return None
    rest = stat[stat.rindex(")") + 2:].split()
    out: Dict[str, Any] = {
        "name": stat[stat.index("(") + 1:stat.rindex(")")],
        "cpu_s": (int(rest[11]) + int(rest[12])) * TICK_S,
        "last_cpu": int(rest[36])}
    schedstat = _read(task / "schedstat")
    if schedstat:
        out["runq_wait_s"] = int(schedstat.split()[1]) * 1e-9
    for line in (_read(task / "sched") or "").splitlines():
        key, _, value = line.partition(":")
        if key.strip() == "se.nr_migrations":
            out["migrations"] = int(value)
    for line in (_read(task / "status") or "").splitlines():
        if line.startswith("nonvoluntary_ctxt_switches:"):
            out["preempted"] = int(line.split()[1])
    return out


def all_threads() -> Dict[int, Dict[str, Any]]:
    try:
        tids = [int(t) for t in os.listdir(PROC / "self" / "task")]
    except OSError:
        return {}
    stats = {tid: thread_stat(tid) for tid in tids}
    return {tid: s for tid, s in stats.items() if s is not None}


def cpu_times(cpus: Set[int]) -> Optional[Dict[str, float]]:
    """Seconds the ``cpus`` spent idle and stolen by the hypervisor, summed
    (``/proc/stat``); None where it counts nothing, as in a sandboxed
    kernel."""
    out = {"idle_s": 0.0, "steal_s": 0.0}
    total = 0
    for line in (_read(PROC / "stat") or "").splitlines():
        m = re.match(r"cpu(\d+) (.*)", line)
        if m and int(m.group(1)) in cpus:
            f = [int(x) for x in m.group(2).split()]
            total += sum(f)
            out["idle_s"] += (f[3] + f[4]) * TICK_S
            out["steal_s"] += (f[7] if len(f) > 7 else 0) * TICK_S
    return out if total else None


def cpu_mhz(cpus: Set[int]) -> Tuple[Optional[float], str]:
    """The mean clock of ``cpus`` as ``/proc/cpuinfo`` shows it, and the
    CPU: its model name, family and model number (two hosts of one name
    may differ in the last)."""
    mhz: List[float] = []
    named: Dict[str, str] = {}
    cpu = None
    for line in (_read(PROC / "cpuinfo") or "").splitlines():
        key, _, value = line.partition(":")
        key = key.strip()
        if key == "processor":
            cpu = int(value)
        elif key in ("model name", "cpu family", "model"):
            named.setdefault(key, value.strip())
        elif key == "cpu MHz" and cpu in cpus:
            mhz.append(float(value))
    model = (f"{named.get('model name', 'unread')} (family "
             f"{named.get('cpu family', '?')} model {named.get('model', '?')})")
    return (sum(mhz) / len(mhz) if mhz else None), model


def loadavg() -> str:
    text = _read(PROC / "loadavg")
    return " ".join(text.split()[:4]) if text else "unread"


class Card:
    """The card's SM clock, power draw and power limit through NVML, read
    only; ``read`` gives None where NVML is not there. The card is CUDA's
    device 0: the first that ``CUDA_VISIBLE_DEVICES`` names by index."""

    def __init__(self) -> None:
        self.lib, self.handle = None, None
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        uint_p = ctypes.POINTER(ctypes.c_uint)
        for name, args in (
                ("nvmlInit_v2", []),
                ("nvmlDeviceGetHandleByIndex_v2",
                 [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]),
                ("nvmlDeviceGetClockInfo",
                 [ctypes.c_void_p, ctypes.c_int, uint_p]),
                ("nvmlDeviceGetPowerUsage", [ctypes.c_void_p, uint_p]),
                ("nvmlDeviceGetEnforcedPowerLimit",
                 [ctypes.c_void_p, uint_p])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        handle = ctypes.c_void_p()
        if lib.nvmlInit_v2() != 0 or lib.nvmlDeviceGetHandleByIndex_v2(
                _visible_index(), ctypes.byref(handle)) != 0:
            return
        self.lib, self.handle = lib, handle

    def read(self) -> Optional[str]:
        if self.handle is None:
            return None
        sm, mw, limit = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_uint()
        lib = self.lib
        if (lib.nvmlDeviceGetClockInfo(self.handle, NVML_CLOCK_SM,
                                       ctypes.byref(sm))
                or lib.nvmlDeviceGetPowerUsage(self.handle, ctypes.byref(mw))
                or lib.nvmlDeviceGetEnforcedPowerLimit(self.handle,
                                                       ctypes.byref(limit))):
            return None
        return (f"sm {sm.value} MHz, {mw.value / 1000:.1f} W of "
                f"{limit.value / 1000:.1f} W")


class Collections:
    """The collector's runs by generation, and their pause, while armed."""

    def __init__(self) -> None:
        self.runs = [0, 0, 0]
        self.pause_s = 0.0
        self._start = 0.0

    def __call__(self, phase: str, info: Dict[str, Any]) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.runs[info["generation"]] += 1
            self.pause_s += time.perf_counter() - self._start


class Watch:
    """The host's readings at the window's open (:meth:`open`) and close
    (:meth:`close`), for the run's named long-lived ``threads`` (name to
    native thread id); :meth:`notes` gives them."""

    def __init__(self, threads: Dict[str, int]) -> None:
        self.threads = threads
        self.cpus = os.sched_getaffinity(0)
        self.card = Card()
        self.gc = Collections()
        self.at: Dict[str, Dict[str, Any]] = {}

    def _reading(self) -> Dict[str, Any]:
        mhz, model = cpu_mhz(self.cpus)
        return {"t": time.monotonic(), "loadavg": loadavg(),
                "threads": all_threads(), "cpu": cpu_times(self.cpus),
                "mhz": mhz, "model": model, "card": self.card.read()}

    def open(self) -> None:
        self.at["open"] = self._reading()
        gc.callbacks.append(self.gc)

    def close(self) -> None:
        gc.callbacks.remove(self.gc)
        self.at["close"] = self._reading()

    def notes(self) -> Dict[str, Any]:
        a, b = self.at["open"], self.at["close"]
        span = b["t"] - a["t"]
        out: Dict[str, Any] = {
            "host_cpu": a["model"],
            "host_mhz": [a["mhz"], b["mhz"]],
            "loadavg": [a["loadavg"], b["loadavg"]],
            "card_clock_power": [a["card"] or "unread",
                                 b["card"] or "unread"],
            "cpus_idle_share": "unread" if not a["cpu"] or not b["cpu"]
            else round((b["cpu"]["idle_s"] - a["cpu"]["idle_s"])
                       / (span * len(self.cpus)), 4),
            "cpus_steal_s": "unread" if not a["cpu"] or not b["cpu"]
            else round(b["cpu"]["steal_s"] - a["cpu"]["steal_s"], 3),
            "gc_runs_by_generation": list(self.gc.runs),
            "gc_pause_s": round(self.gc.pause_s, 6),
        }
        for name, tid in self.threads.items():
            s0, s1 = a["threads"].get(tid), b["threads"].get(tid)
            if s0 is None or s1 is None:
                out[f"thread_{name}"] = "unread"
                continue
            out[f"thread_{name}"] = {
                "last_cpu": s1["last_cpu"],
                "cpu_s": round(s1["cpu_s"] - s0["cpu_s"], 3),
                **{k: (round(s1[k] - s0[k], 4) if isinstance(s1[k], float)
                       else s1[k] - s0[k])
                   for k in ("runq_wait_s", "migrations", "preempted")
                   if k in s0 and k in s1}}
        named = {t.native_id: t.name for t in threading.enumerate()}
        busy = sorted(((s1["cpu_s"] - a["threads"][tid]["cpu_s"],
                        f"{named.get(tid, s1['name'])}:{tid}")
                       for tid, s1 in b["threads"].items()
                       if tid in a["threads"]), reverse=True)
        out["threads_cpu_s"] = {name: round(s, 3)
                                for s, name in busy[:TOP_THREADS]}
        out["threads_total_cpu_s"] = round(sum(s for s, _ in busy), 3)
        return out


def thread_ids(**named: Optional[threading.Thread]) -> Dict[str, int]:
    """Native ids of the run's long-lived threads by name, the calling
    thread as ``main``; a thread not started is left out."""
    out = {"main": threading.get_native_id()}
    out.update({k: t.native_id for k, t in named.items()
                if t is not None and t.native_id is not None})
    return out
