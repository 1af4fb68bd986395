"""The port's lock-order detector (``tpu_cluster_torch.lockorder``)
against the reference's, and the leaf-only lock pins of the port's
controllers.

Two layers:

- the reference's unit scenarios (ABBA, three-lock cycle, RLock
  re-entry, self-reacquire, timed re-acquire, trylock, Condition on a
  Lock and on an RLock, out-of-order release), each run on a PRIVATE
  monitor of each package (``make_lock`` only): equal violations and
  equal edges, exactly. The port's ``install``/``uninstall`` run only
  in a subprocess, never in this process;
- the leaf-only pins for the port's admission, maintenance, event
  recorder, metricsdb and informer locks, read from the process-wide
  monitor the test suite installs (``tpu_cluster.lockorder.installed()``;
  skipped, as the reference's pins are, under ``TPU_LOCKORDER=0``).
  Lock nodes are named by file basename, so the port's locks share the
  reference's node names and feed the same soak pin.
"""

import subprocess
import sys
import threading
import time

import pytest

from fake_apiserver import FakeApiServer, fleet_store
from torch_apply_helpers import REPO, no_nagle  # noqa: F401
from tpu_cluster import lockorder as ref_lockorder
from tpu_cluster_torch import (admission, events, kubeapply, lockorder,
                               maintenance, metricsdb, telemetry)

FAST_RETRY = kubeapply.RetryPolicy(attempts=8, base_s=0.02, cap_s=0.3)
LAYOUT = "h100-sxm5-80gb-8"


# ---------------------------------------------------------------- units


def _abba(m):
    a, b = m.make_lock("A"), m.make_lock("B")
    with a:
        with b:
            pass
    assert m.snapshot_violations() == []
    with b:
        with a:
            pass


def _three_lock_cycle(m):
    a, b, c = m.make_lock("A"), m.make_lock("B"), m.make_lock("C")
    for first, second in ((a, b), (b, c)):
        with first:
            with second:
                pass
    with c:
        with a:
            pass


def _rlock_reentry(m):
    r = m.make_lock("R", reentrant=True)
    with r:
        with r:
            pass


def _self_reacquire(m):
    a = m.make_lock("A")
    with a:
        with pytest.raises(RuntimeError, match="self-deadlock"):
            a.acquire()


def _timed_reacquire(m):
    a = m.make_lock("A")
    with a:
        assert a.acquire(timeout=0.05) is False
    with a:
        pass


def _trylock(m):
    a, b = m.make_lock("A"), m.make_lock("B")
    with a:
        assert b.acquire(blocking=False)
        b.release()
    with b:
        with a:
            pass


def _condition(m, reentrant):
    lk = m.make_lock("CVL", reentrant=reentrant)
    cv = threading.Condition(lk)
    hits = []

    def waiter():
        with cv:
            if reentrant:
                with lk:
                    while not hits:
                        cv.wait(timeout=5)
            else:
                while not hits:
                    cv.wait(timeout=5)
            hits.append("woken")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        hits.append("posted")
        cv.notify()
    t.join(timeout=10)
    assert not t.is_alive()
    assert hits == ["posted", "woken"]
    with lk:
        pass


def _out_of_order_release(m):
    a, b = m.make_lock("A"), m.make_lock("B")
    a.acquire()
    b.acquire()
    a.release()
    b.release()
    with b:
        pass


def _nested_then_sibling(m):
    a, b, c = m.make_lock("A"), m.make_lock("B"), m.make_lock("C")
    with a:
        with b:
            with c:
                pass
    with a:
        with c:
            pass


SCENARIOS = {
    "abba": (_abba, 1, {("A", "B"), ("B", "A")}),
    "three-lock-cycle": (_three_lock_cycle, 1,
                         {("A", "B"), ("B", "C"), ("C", "A")}),
    "rlock-reentry": (_rlock_reentry, 0, set()),
    "self-reacquire": (_self_reacquire, 1, set()),
    "timed-reacquire": (_timed_reacquire, 0, set()),
    "trylock": (_trylock, 0, {("B", "A")}),
    "condition-lock": (lambda m: _condition(m, False), 0, set()),
    "condition-rlock": (lambda m: _condition(m, True), 0, set()),
    "out-of-order-release": (_out_of_order_release, 0, {("A", "B")}),
    "nested-then-sibling": (_nested_then_sibling, 0,
                            {("A", "B"), ("A", "C"), ("B", "C")}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_private_monitor_verdicts_equal_the_reference(name):
    scenario, n_violations, edges = SCENARIOS[name]
    results = []
    for mod in (ref_lockorder, lockorder):
        m = mod.LockOrderMonitor()
        scenario(m)
        results.append((m.snapshot_violations(),
                        set(m.snapshot_edges())))
    assert results[1] == results[0]
    violations, got_edges = results[1]
    assert len(violations) == n_violations, violations
    assert got_edges == edges
    if name == "abba":
        assert "cycle" in violations[0]
        assert "A" in violations[0] and "B" in violations[0]


def test_genuine_factories_come_from_thread_not_a_patched_threading():
    """The suite's monitor (the reference's) has patched ``threading``
    before this module was imported: the port's monitor still holds raw
    locks, and its private locks track nothing into the suite's graph."""
    import _thread
    assert lockorder._RAW_LOCK is _thread.allocate_lock
    assert lockorder._RAW_RLOCK is _thread.RLock
    m = lockorder.LockOrderMonitor()
    assert not isinstance(m._meta, (lockorder._TrackedLock,
                                    ref_lockorder._TrackedLock))
    lock = m.make_lock("X")
    assert not isinstance(lock._inner, ref_lockorder._TrackedLock)


_INSTALL_SCRIPT = r"""
import _thread, sys, threading
sys.path.insert(0, {repo!r})
first = {first!r}
if first:
    from tpu_cluster import lockorder as ref
    ref_monitor = ref.install()
    patched = threading.Lock
from tpu_cluster_torch import lockorder
m = lockorder.install()
assert lockorder.install() is m and lockorder.installed() is m
from tpu_cluster_torch import kubeapply
c = kubeapply.Client("http://127.0.0.1:1")
assert isinstance(c._conns_lock, lockorder._TrackedLock), c._conns_lock
assert c._conns_lock.name == "kubeapply.py:Client._conns_lock"
assert c._ssa_probe_lock.reentrant
# a lock made by stdlib code stays a real lock
import queue
assert not isinstance(queue.Queue().mutex, lockorder._TrackedLock)
assert not isinstance(m._meta, lockorder._TrackedLock)
if first:
    assert not isinstance(m._meta, ref._TrackedLock)
a = threading.Lock()
b = threading.Lock()
with a:
    with b:
        pass
with b:
    with a:
        pass
assert len(m.snapshot_violations()) == 1, m.snapshot_violations()
if first:
    assert ref_monitor.snapshot_violations() == []
lockorder.uninstall()
assert lockorder.installed() is None
assert threading.Lock is _thread.allocate_lock
assert threading.RLock is _thread.RLock
print("ok")
"""


@pytest.mark.parametrize("first", [False, True],
                         ids=["alone", "after-reference"])
def test_install_and_uninstall_in_a_subprocess(first):
    code = _INSTALL_SCRIPT.format(repo=REPO, first=first)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == "ok\n"


# ------------------------------------------------- leaf-only lock pins


def _monitor():
    monitor = ref_lockorder.installed()
    if monitor is None:
        pytest.skip("lock-order monitor disabled (TPU_LOCKORDER=0)")
    return monitor


def _outgoing(monitor, *files):
    return {e: s for e, s in monitor.snapshot_edges().items()
            if any(f in e[0] for f in files)}


def test_port_locks_are_tracked_under_their_site_names():
    _monitor()
    client = kubeapply.Client("http://127.0.0.1:1")
    assert isinstance(client._conns_lock, ref_lockorder._TrackedLock)
    assert client._conns_lock.name == "kubeapply.py:Client._conns_lock"
    client.close()
    ctrl = admission.AdmissionController(client, "gpu-system")
    assert ctrl._lock.name == "admission.py:AdmissionController._lock"


def test_admission_lock_stays_leaf_only():
    monitor = _monitor()
    tel = telemetry.Telemetry()
    with FakeApiServer(auto_ready=True) as api:
        client = kubeapply.Client(api.url, telemetry=tel)
        for n in ("lk-a", "lk-b"):
            client.apply(admission.node_manifest(n, LAYOUT))
        client.apply(admission.gang_job_manifest("locky", LAYOUT,
                                                 "gpu-system", hosts=2))
        ctrl = admission.AdmissionController(client, "gpu-system",
                                             telemetry=tel)
        assert ctrl.step().admitted
        api.set_node_ready("lk-b", ready=False)
        ctrl.step()
        api.set_node_ready("lk-b", ready=True)
        ctrl.step()
        client.close()
    assert _outgoing(monitor, "admission.py") == {}


def test_maintenance_lock_stays_leaf_only():
    monitor = _monitor()
    tel = telemetry.Telemetry()
    names = ("lk-m-a", "lk-m-b")
    with FakeApiServer(auto_ready=True) as api:
        client = kubeapply.Client(api.url, telemetry=tel)
        for n in names:
            client.apply(admission.node_manifest(n, LAYOUT))
        plan = maintenance.plan_waves(
            [admission.HostCapacity(n, LAYOUT, 8, True) for n in names],
            "v9", group_size=1)
        ctrl = maintenance.MaintenanceController(client, "gpu-system",
                                                 plan=plan, telemetry=tel)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if ctrl.step().complete:
                break
        assert ctrl.state_snapshot().complete
        client.close()
    assert _outgoing(monitor, "maintenance.py") == {}


def test_event_recorder_lock_stays_leaf_only():
    monitor = _monitor()
    tel = telemetry.Telemetry()
    cm = {"apiVersion": "v1", "kind": "ConfigMap",
          "metadata": {"name": "lk-ev", "namespace": "gpu-system"}}
    chaos = [{"status": 403, "method": "PATCH", "match": "/events/",
              "count": 1}]
    with FakeApiServer(auto_ready=True, chaos=chaos) as api:
        client = kubeapply.Client(api.url, telemetry=tel)
        rec = events.EventRecorder(client, telemetry=tel, spam_burst=3,
                                   spam_refill_per_s=0.0)
        rec.emit(cm, "LockDrive", "post")
        rec.emit(cm, "LockDrive", "post")
        for i in range(4):
            rec.emit(cm, "LockDrive", f"spam {i}")
        client.close()
    assert rec.counts()["failures"] >= 1
    assert rec.counts()["dropped"] >= 1
    assert _outgoing(monitor, "events.py") == {}


def test_metricsdb_locks_stay_leaf_only():
    """Scrape, ingest, query, the live SLO and the dash, all under the
    monitor: no metricsdb lock is held across another acquisition."""
    monitor = _monitor()
    tel = telemetry.Telemetry()
    tsdb = metricsdb.TSDB()
    with FakeApiServer(auto_ready=True) as api:
        client = kubeapply.Client(api.url, telemetry=tel)
        client.apply({"apiVersion": "v1", "kind": "ConfigMap",
                      "metadata": {"name": "lk-mdb",
                                   "namespace": "default"}})
        server = metricsdb.MetricsServer(tel.metrics, 0).start()
        manager = metricsdb.ScrapeManager(
            [metricsdb.Target("fake", api.url + "/__fake_metrics"),
             metricsdb.Target("self", server.url)],
            tsdb, interval_s=0.02, telemetry=tel)
        try:
            manager.start()
            deadline = time.monotonic() + 10
            while manager.scrapes() < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            client.get("/api/v1/namespaces/default/configmaps/lk-mdb")
            manager.scrape_once()
            tsdb.rate("fake_apiserver_requests_total", 60.0)
            tsdb.histogram_quantile(0.99, telemetry.REQUEST_SECONDS,
                                    window_s=60.0)
            assert metricsdb.live_slo_report(tsdb).ok
            assert "self" in metricsdb.render_dash(tsdb)
            tsdb.dump()
        finally:
            manager.stop()
            server.stop()
            client.close()
    assert _outgoing(monitor, "metricsdb.py") == {}


def test_informer_locks_stay_leaf_only():
    monitor = _monitor()
    tel = telemetry.Telemetry()
    with FakeApiServer(auto_ready=True,
                       store=fleet_store(40, pods_per_node=0)) as api:
        client = kubeapply.Client(api.url, retry=FAST_RETRY,
                                  telemetry=tel, list_page_limit=20)
        client.apply(admission.gang_job_manifest("lk-fleet", LAYOUT,
                                                 "gpu-system", hosts=2))
        ctrl = admission.AdmissionController(client, "gpu-system",
                                             telemetry=tel)
        informers = ctrl.build_informers(page_limit=20, window_s=1)
        try:
            informers.start()
            assert informers.wait_synced(30)
            ctrl.step()
            api.touch("/api/v1/nodes/fleet-0001")
            api.flap()
            deadline = time.monotonic() + 10
            nodes_inf = informers.informers[admission.NODES_PATH]
            while nodes_inf.relists < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert nodes_inf.relists == 2, nodes_inf.relists
            ctrl.step()
        finally:
            informers.stop()
            client.close()
    assert _outgoing(monitor, "informer.py", "muxhttp.py") == {}


def test_the_suite_graph_stays_cycle_free():
    """After the port's drives above (same worker), the process-wide
    graph holds no violation."""
    monitor = _monitor()
    violations = monitor.snapshot_violations()
    assert violations == [], "\n".join(violations)
