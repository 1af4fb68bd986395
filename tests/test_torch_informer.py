"""The port's informer (``tpu_cluster_torch.informer``) against the
reference's (``tpu_cluster/informer.py``), each on its own fake
apiserver seeded with the same synthetic fleet.

What is compared, exactly: the paginated initial sync (LIST pages on the
server's log, the cache), zero requests while idle, one event applied in
O(events), exactly one paginated re-LIST after an apiserver flap, the
denied watch's loud failure (the error raised, the SyncLost Event), and
the informer telemetry families. Watch windows are one second, so
``stop()`` -- which returns when the window ends -- stays short.
"""

import time

import pytest

from fake_apiserver import FakeApiServer, fleet_store
from torch_apply_helpers import packages, no_nagle  # noqa: F401

REF, PORT = packages()
PACKAGES = (REF, PORT)
NODES = "/api/v1/nodes"


def _lists(log):
    return [p for m, p in log
            if m == "GET" and p.partition("?")[0] == NODES
            and "watch=1" not in p]


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _client(pkg, api):
    return pkg.kubeapply.Client(
        api.url, retry=pkg.kubeapply.RetryPolicy(attempts=8, base_s=0.02,
                                                 cap_s=0.5))


def test_paginated_sync_idles_at_zero_requests():
    out = {}
    for pkg in PACKAGES:
        with FakeApiServer(auto_ready=True,
                           store=fleet_store(250, pods_per_node=0)) as api:
            client = _client(pkg, api)
            tel = pkg.telemetry.Telemetry()
            with pkg.informer.Informer(client, NODES, telemetry=tel,
                                       page_limit=100, window_s=1) as inf:
                assert inf.wait_synced(10)
                assert _until(lambda: inf.reconnects >= 1)
                idle_from = len(api.log)
                time.sleep(0.3)
                # a window that ends re-opens its watch: not a read
                idle = [e for e in api.log[idle_from:]
                        if "watch=1" not in e[1]]
                seq = inf.seq()
                api.touch(f"{NODES}/fleet-0100")
                moved = inf.wait_event(seq, timeout=5) > seq
                record = {"cache": sorted(inf.snapshot()),
                          "lists": _lists(api.log), "idle": idle,
                          "relists": inf.relists, "moved": moved,
                          "events": inf.events}
            client.close()
            rendered = tel.metrics.render()
            record["families"] = [
                name for name in ("tpuctl_informer_events_total",
                                  "tpuctl_informer_relists_total",
                                  "tpuctl_informer_lag_seconds")
                if name in rendered]
            out[pkg.name] = record
    assert out["port"] == out["reference"]
    port = out["port"]
    assert len(port["cache"]) == 250 and port["idle"] == []
    assert len(port["lists"]) == 3 and port["relists"] == 1
    assert port["moved"] and port["events"] == 1
    assert len(port["families"]) == 3


def test_a_flap_costs_exactly_one_paginated_relist():
    out = {}
    for pkg in PACKAGES:
        with FakeApiServer(auto_ready=True,
                           store=fleet_store(200, pods_per_node=0)) as api:
            client = _client(pkg, api)
            with pkg.informer.Informer(client, NODES, page_limit=100,
                                       window_s=1) as inf:
                assert inf.wait_synced(10)
                before = len(_lists(api.log))
                api.flap()
                assert _until(lambda: inf.relists >= 2)
                time.sleep(0.3)  # a storm would re-LIST again
                seq = inf.seq()
                api.touch(f"{NODES}/fleet-0003")
                moved = inf.wait_event(seq, timeout=5) > seq
                out[pkg.name] = {"relists": inf.relists,
                                 "relist_pages": len(_lists(api.log))
                                 - before,
                                 "cache": len(inf.snapshot()),
                                 "moved": moved}
            client.close()
    assert out["port"] == out["reference"] == {
        "relists": 2, "relist_pages": 2, "cache": 200, "moved": True}


def test_a_denied_watch_fails_loudly():
    out = {}
    for pkg in PACKAGES:
        with FakeApiServer(auto_ready=True, reject_watch={NODES: 403},
                           store=fleet_store(5, pods_per_node=0)) as api:
            client = pkg.kubeapply.Client(
                api.url, retry=pkg.kubeapply.RetryPolicy(attempts=2,
                                                         base_s=0.01))
            rec = pkg.events.EventRecorder(client, component="informer")
            with pkg.informer.InformerSet(client, [NODES], window_s=1,
                                          events=rec) as infs:
                inf = infs.informers[NODES]
                # the error is recorded first, the SyncLost Event posted
                # right after it
                assert _until(lambda: inf.error is not None
                              and api.paths("/events/"))
                with pytest.raises(pkg.kubeapply.ApplyError) as info:
                    infs.check()
                with pytest.raises(pkg.kubeapply.ApplyError):
                    inf.wait_synced(0.2)
                events = [(e["reason"], e["type"])
                          for e in (api.get(p)
                                    for p in sorted(api.paths("/events/")))]
                out[pkg.name] = [str(info.value), inf.synced, events]
            client.close()
    assert out["port"] == out["reference"]
    message, synced, events = out["port"]
    assert "watch denied" in message and synced is True
    assert events == [("SyncLost", "Warning")]
