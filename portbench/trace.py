"""The device trace of the measured window: ``torch.profiler`` over the
window, reduced to the device's busy time, the kernels that ran and the
host's activity in the gaps between them.

The window is the harness's own ``portbench.window`` span in the trace,
so the profiler's clock never has to be matched with the host's. Host
operations are recorded on the thread that opens the window alone: a
training run does its work there. A serving run's engine works on a
thread of its own, which is not recorded, because recording its every
host operation slows its turn and the traced run would no longer be the
system timed; CUPTI still records its CUDA runtime calls, so a gap is
named by the call the host was in, or "python" between calls.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

WINDOW_SPAN = "portbench.window"
KERNEL_NAMES_DIR = Path(__file__).resolve().parent / "kernel_names"
_TOP = 10
_NAME_CHARS = 100


def kernel_names(group: str) -> List[str]:
    """The kernel names that count as ``group`` (a folder under
    ``kernel_names/``): one file per name, the file's stem."""
    return sorted(p.stem for p in (KERNEL_NAMES_DIR / group).glob("*.txt"))


@dataclass
class DeviceTrace:
    """What the device did in the window, in seconds."""

    window_s: float
    busy_s: float
    ops: List[Tuple[str, float]]       # (name, duration in the window)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def matching(self, names: Sequence[str]) -> Tuple[int, float]:
        """Launches and device seconds of the operations whose name holds
        one of ``names`` as a whole identifier."""
        if not names:
            return 0, 0.0
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        hits = [d for n, d in self.ops if pat.search(n)]
        return len(hits), sum(hits)

    def breakdown(self) -> Dict[str, List[List]]:
        by_name: Dict[str, float] = {}
        for name, dur in self.ops:
            key = name[:_NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:_TOP]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


@contextlib.contextmanager
def profiled(enabled: bool, tracer) -> Iterator[Optional[object]]:
    """``torch.profiler`` over CUDA activity and the calling thread's host
    activity while ``enabled``, else nothing. The port's ``tracer`` has
    its clock anchor read again as the profiler starts, so that its spans
    land on the profiler's clock (``Tracer.wall_ns``), and once more as it
    stops: how far the wall clock moved against the monotonic one in
    between is left on the profiler as ``clock_drift_ns``, and the start's
    anchor kept."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tracer.reanchor()
        start = tracer.anchor
        yield prof
        tracer.reanchor()
        prof.clock_drift_ns = ((tracer.anchor[0] - tracer.anchor[1])
                               - (start[0] - start[1]))
        tracer.anchor = start


def window_span():
    """The span that marks the measured window in the trace."""
    from torch.profiler import record_function
    return record_function(WINDOW_SPAN)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def _label_gaps(gaps: List[Tuple[int, int]],
                host: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Idle seconds by the innermost host operation running at each gap's
    midpoint; "python" where no operation ran."""
    out: Dict[str, float] = {}
    host = sorted(host)
    active: List[Tuple[int, int, str]] = []
    i = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        label = min(active, key=lambda h: h[1] - h[0])[2] if active \
            else "python"
        out[label] = out.get(label, 0.0) + (g1 - g0) * 1e-9
    return out


def reduce(prof) -> DeviceTrace:
    """The window's :class:`DeviceTrace` from a finished profiler."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    # the span on the host; the profiler mirrors annotations on the device
    window = [e for e in events if e.name() == WINDOW_SPAN
              and e.device_type() == DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"{len(window)} '{WINDOW_SPAN}' spans in the trace")
    w0 = window[0].start_ns()
    w1 = w0 + window[0].duration_ns()
    device: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if end <= w0 or start >= w1 or _annotation(e) \
                or e.name() == WINDOW_SPAN:
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append((max(start, w0), min(end, w1), e.name()))
        else:
            host.append((start, end, e.name()))
    busy = _union([(s, e) for s, e, _ in device])
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if prev < w1:
        gaps.append((prev, w1))
    return DeviceTrace(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        ops=[(n, (e - s) * 1e-9) for s, e, n in device],
        idle_by_host=_label_gaps(gaps, host))


def _annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False
