"""Shared LIST+watch informer cache: the client-go informer shape for
this stack's Python controllers. The port's own copy of
``tpu_cluster/informer.py``.

Why this exists: the polling admission controller LISTs every Node
and Job on EVERY pass. At 20
objects that is noise; at a 1000-node fleet every idle tick ships the
whole world twice. Real control planes stay sublinear by paying the full
LIST exactly once (paginated, bounded bodies) and then holding ONE watch
stream per collection: the cache is updated in O(events), consumers read
snapshots for free, and an idle cluster costs zero requests per tick.

One :class:`Informer` owns one collection:

- **Initial sync** — a paginated LIST (``Client.list_paged``; the
  ``limit``/``continue`` chase, bounded bodies at fleet size) fills the
  cache and yields the resourceVersion the watch resumes from.
- **Watch loop** — one ``?watch=1`` stream per window, resumed from the
  last seen resourceVersion. MODIFIED/ADDED events upsert the cache,
  DELETED evicts; each applied batch bumps the event sequence and pokes
  the (optional) ``notify`` callback — the controller's wake signal.
- **410 resume** — an ERROR/410 event (or a resourceVersion the server
  compacted past, e.g. after an apiserver flap) re-LISTs ONCE and
  re-watches; a clean window expiry re-watches from the held RV with NO
  re-LIST. ``tpuctl_informer_relists_total`` counts the full re-syncs —
  an idle fleet holds it at its post-sync value (the zero-LIST pin).

Telemetry families (``tpuctl_informer_events_total{collection,type}``,
``tpuctl_informer_relists_total{collection,reason}``,
``tpuctl_informer_lag_seconds``) are the informer's vitals; LIST pages
ride the client's ``tpuctl_list_pages_total``.

Concurrency: ``_lock`` guards the cache + sequence and is LEAF-ONLY —
all apiserver I/O, telemetry emission and the ``notify`` callback happen
OUTSIDE it (the admission-lock discipline, pinned by
the lock-order tests). The watch thread is the only writer; any
thread may snapshot/wait.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import kubeapply, telemetry as _telemetry

# Default page size for the initial sync and 410 re-LISTs: small enough
# to bound bodies at fleet scale, big enough that a 20-object bundle
# still syncs in one page.
DEFAULT_PAGE_LIMIT = 200


class Informer:
    """One collection's LIST+watch cache. ``start()`` spawns the watch
    thread; ``wait_synced()`` blocks until the initial LIST landed;
    ``snapshot()`` returns ``{name: object}``; ``seq()``/``wait_event``
    expose the event sequence consumers wake on. ``stop()`` severs the
    stream and joins."""

    def __init__(self, client: kubeapply.Client, path: str,
                 telemetry: Optional[_telemetry.Telemetry] = None,
                 page_limit: int = DEFAULT_PAGE_LIMIT,
                 window_s: int = 30,
                 notify: Optional[Callable[[], None]] = None,
                 events: Optional[Any] = None) -> None:
        self.client = client
        self.path = path
        self.telemetry = telemetry
        # Events pipeline: an events.EventRecorder. The
        # informer reports its two operationally-interesting states as
        # Events on the collection it watches: a 410-driven re-LIST
        # ("Relisted" — a RELIST STORM shows up as ONE aggregated Event
        # with a climbing count, which is the point) and a terminal
        # watch failure ("SyncLost", Warning — the cache is frozen and
        # consumers are about to find out). Fail-open like every other
        # recorder call site; None (default) = no events.
        self.event_recorder = events
        self.page_limit = max(1, int(page_limit))
        self.window_s = max(1, int(window_s))
        self._notify = notify
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._cache: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._synced = False  # guarded-by: _lock
        self._rv = ""  # guarded-by: _lock
        self._error: Optional[str] = None  # guarded-by: _lock
        # lifetime counters, mirrored into the telemetry families when
        # one is attached (read via the properties below)
        self._events = 0  # guarded-by: _lock
        self._relists = 0  # guarded-by: _lock
        self._reconnects = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the live watch connection, severed by stop() so the blocking
        # readline wakes immediately instead of at window end
        self._conn_lock = threading.Lock()
        self._conn: Optional[Any] = None  # guarded-by: _conn_lock

    # ------------------------------------------------------------ surface

    def start(self) -> "Informer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"informer{self.path.replace('/', '-')}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._conn_lock:
            conn = self._conn
        if conn is not None:
            # shutdown, not just close: only a shutdown reliably
            # unblocks a readline parked in recv (the sever rule)
            sock = getattr(conn, "sock", None)
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            try:
                conn.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._cond:
            self._cond.notify_all()

    def __enter__(self) -> "Informer":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    def wait_synced(self, timeout: float = 30.0) -> bool:
        """True once the initial LIST landed (False on timeout; a sync
        FAILURE raises the recorded error — a controller must not run
        forever against an empty cache it believes is the world)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                # a recorded terminal error outranks a stale "synced":
                # a watch denied AFTER sync leaves the cache frozen, and
                # a consumer re-checking sync must hear about it
                if self._error is not None:
                    raise kubeapply.ApplyError(
                        f"informer {self.path}: {self._error}")
                if self._synced:
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 1.0))

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """{name: object} — a shallow-copied view of the cache (objects
        are shared read-only; consumers must not mutate them)."""
        with self._lock:
            return dict(self._cache)

    def seq(self) -> int:
        with self._lock:
            return self._seq

    def wait_event(self, last: int, timeout: float) -> int:
        """Block until the event sequence passes ``last`` (or timeout);
        returns the current sequence either way."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._seq <= last and not self._stop.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(min(left, 1.0))
            return self._seq

    @property
    def synced(self) -> bool:
        """Non-blocking: has the initial LIST landed? A snapshot taken
        before sync is an EMPTY world, not a small one — consumers that
        act on snapshots (admission) must not read until this is
        true."""
        with self._lock:
            return self._synced

    @property
    def error(self) -> Optional[str]:
        """The recorded terminal error (watch denied, re-LIST failed),
        or None while healthy. A consumer looping on snapshots must
        poll this (or :meth:`InformerSet.check`): after a terminal
        error the watch thread is gone and the cache is FROZEN — acting
        on it is arbitrating against a world that no longer exists."""
        with self._lock:
            return self._error

    @property
    def relists(self) -> int:
        with self._lock:
            return self._relists

    @property
    def events(self) -> int:
        with self._lock:
            return self._events

    @property
    def reconnects(self) -> int:
        with self._lock:
            return self._reconnects

    # ------------------------------------------------------------ internals

    def _poke(self) -> None:
        """Wake consumers (condition + notify callback) — called OUTSIDE
        ``_lock``-guarded mutation, so the callback can take any lock it
        wants without nesting under ours."""
        notify = self._notify
        if notify is not None:
            notify()

    def _observe_lag(self, t_received: float) -> None:
        tel = self.telemetry
        if tel is not None:
            tel.histogram(
                _telemetry.INFORMER_LAG_SECONDS,
                "seconds from watch-event receipt to cache applied"
            ).observe(max(0.0, time.monotonic() - t_received))

    def _count_relist(self, reason: str) -> None:
        with self._lock:
            self._relists += 1
        tel = self.telemetry
        if tel is not None:
            tel.counter(_telemetry.INFORMER_RELISTS_TOTAL,
                        "full informer re-LISTs (initial sync + 410 "
                        "resume)", collection=self.path,
                        reason=reason).inc()
        rec = self.event_recorder
        if rec is not None and reason != "initial":
            # the initial sync is routine; RESUMES are the signal — and
            # a storm of them aggregates into one counted Event
            from . import events as eventsmod
            rec.emit(eventsmod.collection_ref(self.path), "Relisted",
                     f"informer on {self.path} re-listed after a "
                     f"{reason} watch invalidation")

    def _note_sync_lost(self, detail: str) -> None:
        """One SyncLost Warning when the informer goes terminal — the
        cache is FROZEN from here on and consumers' check() is about to
        start raising."""
        rec = self.event_recorder
        if rec is not None:
            from . import events as eventsmod
            rec.emit(eventsmod.collection_ref(self.path), "SyncLost",
                     f"informer on {self.path} lost its watch: {detail}",
                     type_="Warning")

    def _count_events(self, by_type: Dict[str, int]) -> None:
        tel = self.telemetry
        if tel is None:
            return
        for ev_type, n in by_type.items():
            tel.counter(_telemetry.INFORMER_EVENTS_TOTAL,
                        "watch events applied to the informer cache",
                        collection=self.path, type=ev_type).inc(n)

    def _resync(self, reason: str) -> Optional[str]:
        """Full re-LIST (paginated) replacing the cache; returns the RV
        to watch from, or None when stopping/failed."""
        try:
            items, rv, _pages = self.client.list_paged(self.path,
                                                       self.page_limit)
        except kubeapply.ApplyError as exc:
            with self._cond:
                self._error = str(exc)
                self._cond.notify_all()
            self._note_sync_lost(str(exc))
            return None
        if self._stop.is_set():
            # stopped while the LIST was in flight: drop the result —
            # a cache mutated after stop() returned is exactly the
            # cross-test interference the join is meant to prevent
            return None
        self._count_relist(reason)
        with self._cond:
            self._cache = dict(items)
            self._rv = rv
            self._seq += 1
            self._synced = True
            self._error = None
            self._cond.notify_all()
        self._poke()
        return rv

    def _run(self) -> None:
        rv = self._resync("initial")
        if rv is None:
            return
        policy = self.client.retry or kubeapply.NO_RETRY
        denials = 0
        while not self._stop.is_set():
            try:
                conn, resp = self.client._open_watch(self.path, rv,
                                                     self.window_s)
                denials = 0
            except kubeapply._WatchDenied as exc:
                denials += 1
                if self._stop.is_set():
                    return
                if exc.code in policy.retryable \
                        and denials < policy.attempts:
                    self._stop.wait(policy.backoff_s(denials))
                    continue
                # terminal refusal: record and stop — an informer that
                # cannot watch must not silently freeze its consumers
                with self._cond:
                    self._error = f"watch denied: {exc}"
                    self._cond.notify_all()
                self._note_sync_lost(f"watch denied: {exc}")
                return
            with self._conn_lock:
                self._conn = conn
            with self._lock:
                self._reconnects += 1
            gone = False
            try:
                # stop() may have snapshotted _conn as None while this
                # connection was still being opened: re-check AFTER
                # registration so the finally below severs it and the
                # thread exits now instead of at window end
                if not self._stop.is_set():
                    gone, rv = self._pump(resp, rv)
            finally:
                with self._conn_lock:
                    self._conn = None
                try:
                    conn.close()
                except OSError:
                    pass
            if self._stop.is_set():
                return
            if gone:
                # compacted history (ERROR/410, or a flapped apiserver):
                # the ONE case that costs a full re-LIST
                new_rv = self._resync("410")
                if new_rv is None:
                    return
                rv = new_rv
            # clean window expiry / stream death: re-watch from the held
            # RV — NO re-LIST (the O(events) contract)

    def _pump(self, resp: Any, rv: str) -> Tuple[bool, str]:
        """Drain one watch stream into the cache. Returns ``(gone,
        rv)`` — ``gone`` when the server invalidated the RV (410)."""
        while not self._stop.is_set():
            try:
                raw = resp.readline()
            except (OSError, ValueError):
                return False, rv
            if not raw:
                return False, rv
            t_received = time.monotonic()
            try:
                ev = json.loads(raw)
            except ValueError:
                continue
            ev_type = str(ev.get("type") or "")
            obj = ev.get("object") or {}
            if ev_type == "ERROR":
                if (obj or {}).get("code") == 410:
                    return True, rv
                continue
            meta = (obj.get("metadata") or {})
            name = meta.get("name")
            new_rv = meta.get("resourceVersion")
            if not name:
                continue
            applied: Dict[str, int] = {}
            with self._cond:
                if new_rv:
                    self._rv = str(new_rv)
                if ev_type == "DELETED":
                    self._cache.pop(str(name), None)
                else:
                    self._cache[str(name)] = obj
                self._seq += 1
                self._events += 1
                applied[ev_type or "MODIFIED"] = 1
                self._cond.notify_all()
            if new_rv:
                rv = str(new_rv)
            self._count_events(applied)
            self._observe_lag(t_received)
            self._poke()
        return False, rv


class InformerSet:
    """A bundle of informers sharing one wake signal — the controller-
    side convenience: ``wait_any_event`` blocks until ANY member applied
    an event (or the resync interval elapsed)."""

    def __init__(self, client: kubeapply.Client, paths: List[str],
                 telemetry: Optional[_telemetry.Telemetry] = None,
                 page_limit: int = DEFAULT_PAGE_LIMIT,
                 window_s: int = 30,
                 events: Optional[Any] = None) -> None:
        self._wake = threading.Event()
        self.informers: Dict[str, Informer] = {
            path: Informer(client, path, telemetry=telemetry,
                           page_limit=page_limit, window_s=window_s,
                           notify=self._wake.set, events=events)
            for path in paths}

    def start(self) -> "InformerSet":
        for inf in self.informers.values():
            inf.start()
        return self

    def stop(self) -> None:
        for inf in self.informers.values():
            inf.stop()
        self._wake.set()

    def __enter__(self) -> "InformerSet":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()

    def wait_synced(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        for inf in self.informers.values():
            if not inf.wait_synced(max(0.1, deadline - time.monotonic())):
                return False
        return True

    def snapshot(self, path: str) -> Dict[str, Dict[str, Any]]:
        return self.informers[path].snapshot()

    def synced(self) -> bool:
        """Non-blocking: every member's initial LIST has landed."""
        return all(inf.synced for inf in self.informers.values())

    def check(self) -> None:
        """Raise when ANY member recorded a terminal error — the
        health probe an event loop runs every wake (run_watch does),
        so a frozen cache fails loudly instead of feeding stale
        snapshots to a controller forever."""
        for inf in self.informers.values():
            err = inf.error
            if err is not None:
                raise kubeapply.ApplyError(
                    f"informer {inf.path}: {err}")

    def wait_any_event(self, timeout: float) -> bool:
        """True when an event arrived before ``timeout``. Wait FIRST,
        clear after: an event that landed while the caller was busy
        (mid-pass) keeps the flag set, so the next wait returns
        immediately instead of sleeping a full resync interval; an
        event racing the clear is covered by the snapshot the caller
        reads right after."""
        hit = self._wake.wait(timeout)
        self._wake.clear()
        return hit
