"""Runtime lock-order detector: an Eraser-style lockset instrument. The
port's own copy of ``tpu_cluster/lockorder.py``, but for where it takes
the genuine lock factories from (below).

The static half of the concurrency suite (tpu_cluster_torch.conlint) proves
annotated state is touched under its lock; THIS module proves the locks
themselves are acquired in a consistent order. It wraps
``threading.Lock``/``threading.RLock`` with tracked proxies, keeps a
per-thread stack of held locks, and records every nesting pair
``held -> acquiring`` as an edge in a global acquisition graph keyed by
the lock's CREATION SITE (``file:Class.attr`` — stable across runs, so
two ``Client`` instances' ``_conns_lock``s are one node). A cycle in
that graph is a potential deadlock: thread A can hold X wanting Y while
thread B holds Y wanting X. Cycles — and re-acquisition of a
non-reentrant lock the thread already holds (a guaranteed self-deadlock)
— are recorded as violations at the moment the edge appears, so the
failure names both sites instead of presenting as a hung test.

:func:`install` patches the factories process-wide: every lock created
in repo files is tracked, every lock created by stdlib/third-party code
stays a REAL lock with zero overhead (the factory inspects the creation
site once). A test suite installs it before any repo code creates a
lock and pins the observed graph: the client/telemetry stack must stay
FLAT (no nesting at all), so any new nesting shows up as a failed pin
and gets reviewed before it can race.

Non-blocking ``acquire(blocking=False)`` records nothing: a trylock
cannot participate in a deadlock. ``threading.Condition`` built on a
tracked lock is tracked transitively (wait/notify release and reacquire
through the proxy).
"""

from __future__ import annotations

import _thread
import linecache
import os
import re
import sys
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

# The GENUINE factories — the monitor's own bookkeeping must never run
# through an instrument, and uninstall must be able to restore them.
# They come from ``_thread``, not from ``threading.Lock``/``RLock`` at
# import: another monitor (the reference package's, in a process that
# imports both) may already have patched ``threading``, and capturing its
# patched factories would track this monitor's own ``_meta`` locks in
# the other graph and make uninstall "restore" the other patch.
_RAW_LOCK = _thread.allocate_lock
_RAW_RLOCK = _thread.RLock

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `self._retry_lock = threading.Lock()` / `lock = Lock()` -> the variable
# name, used to build a stable node name for the creation site.
_NAME_RE = re.compile(
    r"(?:self\.)?(\w+)\s*(?::[^=]*)?=\s*[\w.]*(?:Lock|RLock|Condition)\(")


class LockOrderMonitor:
    """One acquisition graph + its violations. The global instance (see
    :func:`install`) backs the patched ``threading`` factories; tests
    build private instances via :meth:`make_lock` for seeded-violation
    fixtures without polluting the global graph."""

    def __init__(self, roots: Optional[Sequence[str]] = None) -> None:
        self._meta = _RAW_LOCK()
        # edge -> "file:line" of the first acquisition that recorded it
        self.edges: Dict[Tuple[str, str], str] = {}  # guarded-by: _meta
        self.violations: List[str] = []              # guarded-by: _meta
        self._tls = threading.local()
        self.roots: Tuple[str, ...] = tuple(
            os.path.abspath(r) for r in (roots or (_REPO_ROOT,)))

    # ------------------------------------------------------------ factory

    def tracked(self, filename: str) -> bool:
        path = os.path.abspath(filename)
        return any(path.startswith(root + os.sep) or path == root
                   for root in self.roots)

    def make_lock(self, name: str, reentrant: bool = False) -> "_TrackedLock":
        """A tracked lock with an explicit node name (test fixtures)."""
        inner = _RAW_RLOCK() if reentrant else _RAW_LOCK()
        return _TrackedLock(self, name, inner, reentrant)

    def _held(self) -> List["_TrackedLock"]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held  # type: ignore[no-any-return]

    # ---------------------------------------------------------- recording

    def note_acquiring(self, lock: "_TrackedLock", site: str) -> None:
        """Pre-acquire bookkeeping for an UNTIMED blocking acquire (the
        only kind that can deadlock forever — trylocks and timed
        acquires self-resolve, so the proxy never routes them here):
        records ``held -> acquiring`` edges, and raises on re-acquiring
        a held non-reentrant lock — that acquire can never return, so
        failing loudly beats hanging the suite."""
        held = self._held()
        for h in held:
            if h is lock:
                if not lock.reentrant:
                    msg = (f"self-deadlock: non-reentrant lock "
                           f"{lock.name} re-acquired at {site} while "
                           "already held by this thread")
                    with self._meta:
                        self.violations.append(msg)
                    raise RuntimeError(msg)
                return  # reentrant level: no new ordering decision
        for h in held:
            self._record_edge(h.name, lock.name, site)

    def note_acquired(self, lock: "_TrackedLock") -> None:
        self._held().append(lock)

    def note_released(self, lock: "_TrackedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def note_wait_release(self, lock: "_TrackedLock") -> int:
        """Condition.wait released EVERY level of ``lock`` via
        _release_save: drop all its held-stack entries, returning how
        many there were so _acquire_restore can put them back."""
        held = self._held()
        count = sum(1 for h in held if h is lock)
        held[:] = [h for h in held if h is not lock]
        return count

    def note_wait_restore(self, lock: "_TrackedLock", count: int) -> None:
        self._held().extend([lock] * count)

    def _record_edge(self, held_name: str, name: str, site: str) -> None:
        if held_name == name:
            # same creation site, different objects: instance-ordered
            # acquisition (A's lock then B's). Not provably cyclic from
            # one observation, but the pinned-flat discipline this repo
            # keeps has no legitimate case for it — surface it.
            with self._meta:
                self.violations.append(
                    f"same-site nesting: two locks from {name} held "
                    f"together at {site}")
            return
        with self._meta:
            key = (held_name, name)
            if key in self.edges:
                return
            self.edges[key] = site
            path = self._find_path_locked(name, held_name)
        if path is not None:
            cycle = [held_name] + path
            with self._meta:
                self.violations.append(
                    "lock-order cycle: " + " -> ".join(cycle)
                    + f" (closing edge acquired at {site})")

    # requires: self._meta
    def _find_path_locked(self, start: str,
                          goal: str) -> Optional[List[str]]:
        """DFS ``start -> ... -> goal`` over edges. Caller holds _meta."""
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        seen: Set[str] = set()
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            if node in seen:
                continue
            seen.add(node)
            for (a, b) in self.edges:
                if a == node:
                    stack.append((b, path + [b]))
        return None

    # ----------------------------------------------------------- reading

    def snapshot_edges(self) -> Dict[Tuple[str, str], str]:
        with self._meta:
            return dict(self.edges)

    def snapshot_violations(self) -> List[str]:
        with self._meta:
            return list(self.violations)


class _TrackedLock:
    """Lock proxy: same acquire/release/context-manager surface as the
    primitive it wraps, feeding the monitor on blocking acquires."""

    def __init__(self, monitor: LockOrderMonitor, name: str,
                 inner: object, reentrant: bool) -> None:
        self._monitor = monitor
        self.name = name
        self._inner = inner
        self.reentrant = reentrant

    def _call_site(self) -> str:
        frame = sys._getframe(2)
        while frame is not None and \
                frame.f_code.co_filename == __file__:
            frame = frame.f_back
        if frame is None:
            return "?"
        return (f"{os.path.basename(frame.f_code.co_filename)}:"
                f"{frame.f_lineno}")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking and timeout == -1:
            # only an acquire that can block FOREVER is an ordering
            # commitment; trylocks and timed acquires self-resolve (a
            # timed re-acquire of a held Lock legally returns False)
            self._monitor.note_acquiring(self, self._call_site())
        ok: bool = self._inner.acquire(  # type: ignore[attr-defined]
            blocking, timeout)
        if ok:
            # every successful acquire pushes one level (reentrant ones
            # included); release pops one
            self._monitor.note_acquired(self)
        return ok

    def release(self) -> None:
        self._inner.release()  # type: ignore[attr-defined]
        self._monitor.note_released(self)

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        return bool(inner_locked()) if inner_locked is not None else False

    # --- threading.Condition integration -------------------------------
    # Condition prefers the lock's own _release_save/_acquire_restore/
    # _is_owned when present. Without forwarding these, a Condition on a
    # tracked RLock breaks in two ways: the default _is_owned probe
    # (acquire(False)) SUCCEEDS reentrantly on an RLock the thread
    # already holds (so wait() raises "cannot wait on un-acquired
    # lock"), and the default _release_save releases only ONE level of a
    # multiply-held RLock. Forward to the primitive and keep the
    # monitor's held stack consistent across the wait window.

    def _is_owned(self) -> bool:
        probe = getattr(self._inner, "_is_owned", None)
        if probe is not None:
            return bool(probe())
        # plain Lock: mirror Condition's own fallback, against the
        # primitive directly (no graph bookkeeping — a trylock probe
        # is not an ordering decision)
        if self._inner.acquire(False):  # type: ignore[attr-defined]
            self._inner.release()  # type: ignore[attr-defined]
            return False
        return True

    def _release_save(self) -> object:
        saver = getattr(self._inner, "_release_save", None)
        if saver is not None:
            state = saver()  # RLock: drops every recursion level
        else:
            self._inner.release()  # type: ignore[attr-defined]
            state = None
        count = self._monitor.note_wait_release(self)
        return (state, count)

    def _acquire_restore(self, saved: object) -> None:
        state, count = saved  # type: ignore[misc]
        restorer = getattr(self._inner, "_acquire_restore", None)
        if restorer is not None:
            restorer(state)
        else:
            self._inner.acquire()  # type: ignore[attr-defined]
        self._monitor.note_wait_restore(self, int(count))

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()

    def _at_fork_reinit(self) -> None:
        reinit = getattr(self._inner, "_at_fork_reinit", None)
        if reinit is not None:
            reinit()
        self._monitor._tls = threading.local()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name} wrapping {self._inner!r}>"


def _site_name(monitor: LockOrderMonitor) -> Optional[str]:
    """Node name for the lock being created by the CALLER of the patched
    factory: ``file.py:Class.var`` (class from the frame's ``self``, var
    regexed off the creation line). None = untracked (non-repo file)."""
    frame = sys._getframe(2)
    while frame is not None and frame.f_code.co_filename == __file__:
        frame = frame.f_back
    if frame is None:
        return None
    filename = frame.f_code.co_filename
    if not monitor.tracked(filename):
        return None
    line = linecache.getline(filename, frame.f_lineno)
    m = _NAME_RE.search(line)
    var = m.group(1) if m else f"L{frame.f_lineno}"
    owner = frame.f_code.co_name
    self_obj = frame.f_locals.get("self")
    if self_obj is not None:
        owner = type(self_obj).__name__
    return f"{os.path.basename(filename)}:{owner}.{var}"


_INSTALLED: Optional[LockOrderMonitor] = None


def install(roots: Optional[Sequence[str]] = None) -> LockOrderMonitor:
    """Patch ``threading.Lock``/``RLock`` so locks created from repo
    files are tracked by a global monitor (idempotent; returns it)."""
    global _INSTALLED
    if _INSTALLED is not None:
        return _INSTALLED
    monitor = LockOrderMonitor(roots)

    def lock_factory() -> object:
        name = _site_name(monitor)
        if name is None:
            return _RAW_LOCK()
        return _TrackedLock(monitor, name, _RAW_LOCK(), reentrant=False)

    def rlock_factory() -> object:
        name = _site_name(monitor)
        if name is None:
            return _RAW_RLOCK()
        return _TrackedLock(monitor, name, _RAW_RLOCK(), reentrant=True)

    threading.Lock = lock_factory  # type: ignore[assignment]
    threading.RLock = rlock_factory  # type: ignore[assignment]
    _INSTALLED = monitor
    return monitor


def installed() -> Optional[LockOrderMonitor]:
    return _INSTALLED


def uninstall() -> None:
    global _INSTALLED
    threading.Lock = _RAW_LOCK  # type: ignore[assignment]
    threading.RLock = _RAW_RLOCK  # type: ignore[assignment]
    _INSTALLED = None
