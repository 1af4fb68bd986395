"""Duty-cycle sampling for the serving engine: the part of
``tpu_cluster/workloads/runtime_metrics.py`` that serving calls.

The owning workload samples itself: :func:`duty_cycle_window` opens a
measurement window and :func:`device_busy` marks the regions where
device execution is in flight (dispatch..sync). The gauge is busy/wall
over the TRAILING ``TPU_METRICS_WINDOW_S`` (default 60 s) seconds — ~0
when scraped after idle, the live rate mid-run. No window, or a window
that never saw activity, publishes nothing: the gauge is only ever a
measured value.

The family name stays ``tpu_duty_cycle_percent``: the autoscaler windows
it and the contract registry pins its spelling. The textfile writer
(``collect_lines``/``write``) and the tensorcore sampler are not ported
yet.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Deque, Iterator, Optional, Tuple

DUTY_CYCLE_PERCENT = "tpu_duty_cycle_percent"

DEFAULT_WINDOW_S = 60.0


def _window_s() -> float:
    try:
        return float(os.environ.get("TPU_METRICS_WINDOW_S",
                                    DEFAULT_WINDOW_S))
    except ValueError:
        return DEFAULT_WINDOW_S


class _WindowAccumulator:
    """Trailing-window machinery: events are ``(end_time, weight,
    duration)`` — a point event has duration 0, a region event spreads
    its weight uniformly over ``[end-dur, end]`` and contributes only the
    in-window part."""

    def __init__(self, window_s: Optional[float]) -> None:
        self.window = float(window_s) if window_s else _window_s()
        self._t0 = time.monotonic()
        self._events: Deque[Tuple[float, float, float]] = \
            collections.deque()
        self.ever = False

    def add(self, weight: float, duration: float = 0.0,
            now: Optional[float] = None) -> None:
        if weight > 0:
            end = time.monotonic() if now is None else now
            self._events.append((end, weight, max(0.0, duration)))
            self.ever = True

    def windowed(self, now: Optional[float] = None) -> Tuple[float, float]:
        """(in-window weight, span seconds). Evicts events entirely before
        the window."""
        now = time.monotonic() if now is None else now
        start = max(self._t0, now - self.window)
        while self._events and self._events[0][0] <= start:
            self._events.popleft()
        total = 0.0
        for end, weight, dur in self._events:
            if end > now:
                continue  # injected future 'now' in tests
            if dur <= 0.0:
                total += weight if end > start else 0.0
            else:
                overlap = max(0.0, min(end, now) - max(end - dur, start))
                total += weight * (overlap / dur)
        return total, now - start


class DutyCycleSampler:
    """Device-busy seconds over a TRAILING window (busy/wall of the last
    ``window_s`` seconds, clipped to the window's open time). ``None``
    until the first busy region is recorded; ``0.0`` once activity has
    been seen but none falls in the trailing window."""

    def __init__(self, window_s: Optional[float] = None) -> None:
        self._acc = _WindowAccumulator(window_s)
        self._t0 = self._acc._t0

    def add_busy(self, seconds: float, now: Optional[float] = None) -> None:
        self._acc.add(seconds, duration=seconds, now=now)

    def percent(self, now: Optional[float] = None) -> Optional[float]:
        busy, span = self._acc.windowed(now)
        if not self._acc.ever or span <= 1e-9:
            return None
        return min(100.0, 100.0 * busy / span)


_active_sampler: Optional[DutyCycleSampler] = None


@contextlib.contextmanager
def duty_cycle_window() -> Iterator[DutyCycleSampler]:
    """Open a duty-cycle measurement window; :func:`device_busy` regions
    inside it feed the yielded sampler."""
    global _active_sampler
    sampler = DutyCycleSampler()
    prev, _active_sampler = _active_sampler, sampler
    try:
        yield sampler
    finally:
        _active_sampler = prev


@contextlib.contextmanager
def device_busy() -> Iterator[None]:
    """Mark a region with device execution in flight (dispatch..sync).
    No-op when no duty-cycle window is open, so workloads can annotate
    unconditionally."""
    sampler = _active_sampler
    t0 = time.monotonic()
    try:
        yield
    finally:
        if sampler is not None:
            sampler.add_busy(time.monotonic() - t0)
