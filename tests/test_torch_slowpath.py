"""The port's apply client under slow faults, hedging, deadlines,
pagination, load shedding and the multiplexed transport
(``tpu_cluster_torch.kubeapply``/``muxhttp``) against the reference's.

Each case runs the reference's client and the port's on the same fault
script against two ``FakeApiServer``s (or the same raw socket server)
and compares, exactly: the outcome (status, body, typed error and its
class, retry and hedge counts, transport-error class), the faults the
fake fired, and the multiset of requests the fake logged, query strings
masked as ``tests/torch_apply_helpers.py`` masks the clock-made parts of
a wire. Rollouts use the port's bundle on both engines. Where a case's
wire count depends on thread timing (a 429 storm from eight threads, a
stale-socket re-send after a severed hedge), it compares the distinct
requests and holds each side to the reference's bound, and says so.
Waits stay under a second a side, but for the stalls the faults script.
"""

import concurrent.futures as cf
import copy
import socket
import threading
import time
from collections import Counter

import pytest

from fake_apiserver import FakeApiServer, fleet_store, slow_fault_script
from torch_apply_helpers import no_nagle  # noqa: F401
from tpu_cluster import kubeapply as ref_kubeapply
from tpu_cluster import muxhttp as ref_muxhttp
from tpu_cluster import telemetry as ref_telemetry
from tpu_cluster_torch import kubeapply, muxhttp, telemetry
from tpu_cluster_torch import spec as specmod
from tpu_cluster_torch.render import manifests, operator_bundle

NS_PATH = "/api/v1/namespaces/gpu-system"
NODES = "/api/v1/nodes"
MUTATING = ("POST", "PATCH", "PUT", "DELETE")
SIDES = ((ref_kubeapply, ref_telemetry), (kubeapply, telemetry))


def fast_retry(ka):
    return ka.RetryPolicy(attempts=8, base_s=0.02, cap_s=0.3)


def port_groups(full=True):
    spec = specmod.default_spec()
    groups = list(manifests.rollout_groups(spec))
    if full:
        groups = list(operator_bundle.operator_install_groups(spec)) + groups
    return groups


def wire(api):
    """The fake's request log as a multiset, query strings dropped."""
    return Counter((m, p.partition("?")[0]) for m, p in api.log)


def both(scenario, chaos=None, log=True, **fake_kw):
    """``scenario(kubeapply, telemetry, api)`` on the reference's engine,
    then the port's, each against a fresh fake with ``chaos``; asserts
    equal results, equal fired faults and (``log``) equal request
    multisets, and returns the port's result."""
    out = []
    for ka, tel in SIDES:
        kw = dict(fake_kw)
        if "store" in kw:
            kw["store"] = copy.deepcopy(kw["store"])
        with FakeApiServer(auto_ready=kw.pop("auto_ready", True),
                           chaos=copy.deepcopy(chaos), **kw) as api:
            result = scenario(ka, tel, api)
            fired = (sorted(api.chaos.fired_snapshot())
                     if api.chaos is not None else [])
            seen = wire(api) if log else None
        out.append((result, fired, seen))
    assert out[1] == out[0]
    return out[1][0]


def error_class(client):
    text = (client.last_transport_error or "").lower()
    for needle, name in (("deadline", "deadline"), ("garbage", "garbage")):
        if needle in text:
            return name
    return text.split(":")[0]


# ------------------------------------------------------------ fault kinds


def test_stall_classifies_transport_zero_and_retries():
    def scenario(ka, tel, api):
        client = ka.Client(api.url, timeout=0.3, retry=fast_retry(ka))
        t0 = time.monotonic()
        code, _ = client.get(NS_PATH)
        assert time.monotonic() - t0 < 1.5
        client.close()
        return code, client.retries
    assert both(scenario, chaos=[{"stall": 2.0, "count": 1}]) == (404, 1)


@pytest.mark.parametrize("wide", [False, True])
def test_trickle_defeats_per_op_timeout_but_not_the_wall(wide):
    chaos = [{"trickle": 30 if wide else 20, "count": 1, "method": "GET",
              "body": {"ok": 1}}]

    def scenario(ka, tel, api):
        if wide:
            client = ka.Client(api.url, timeout=0.2,
                               attempt_deadline_s=10.0,
                               retry=fast_retry(ka))
        else:
            client = ka.Client(api.url, timeout=0.4, retry=fast_retry(ka))
        t0 = time.monotonic()
        code, obj = client.get(NS_PATH)
        elapsed = time.monotonic() - t0
        client.close()
        assert (elapsed > 0.25) if wide else (elapsed < 1.5), elapsed
        if wide:
            return code, obj, client.retries
        return code, client.retries, error_class(client)
    assert both(scenario, chaos=chaos) == ((200, {"ok": 1}, 0) if wide
                                           else (404, 1, "deadline"))


def test_truncate_mid_chunk_classifies_transport_zero():
    def scenario(ka, tel, api):
        client = ka.Client(api.url, timeout=0.5, retry=fast_retry(ka))
        code, _ = client.get(NS_PATH)
        client.close()
        return code, client.retries
    assert both(scenario, chaos=[{"truncate": True, "count": 1}]) == \
        (404, 1)


@pytest.mark.parametrize("keep_alive", [True, False])
def test_garbage_200_classifies_transport_zero(keep_alive):
    def scenario(ka, tel, api):
        client = ka.Client(api.url, timeout=0.5, retry=fast_retry(ka),
                           keep_alive=keep_alive)
        code, _ = client.get(NS_PATH)
        client.close()
        return code, client.retries, error_class(client)
    assert both(scenario, chaos=[{"garbage": True, "count": 1}]) == \
        (404, 1, "garbage")


def test_slow_faults_share_the_retry_taxonomy():
    for status in (0, 200, 404, 409, 410, 429, 500, 501, 503, 504):
        assert kubeapply.RetryPolicy().classify(status) == \
            ref_kubeapply.RetryPolicy().classify(status), status
    assert kubeapply.RETRYABLE_STATUSES == ref_kubeapply.RETRYABLE_STATUSES


def test_every_slow_fault_kind_lands_on_the_fakes_counter():
    chaos = [{"stall": 0.1, "count": 1}, {"trickle": 500, "count": 1},
             {"truncate": True, "count": 1}, {"garbage": True, "count": 1}]

    def scenario(ka, tel, api):
        client = ka.Client(api.url, timeout=0.3, retry=fast_retry(ka))
        codes = [client.get(NS_PATH)[0] for _ in range(6)]
        client.close()
        text = api.fake_metrics_text()
        return codes, [kind for kind in ("stall", "trickle", "truncate",
                                         "garbage")
                       if f'fake_apiserver_chaos_faults_total{{kind="'
                          f'{kind}"}}' in text]
    codes, kinds = both(scenario, chaos=chaos)
    assert codes[1:] == [404] * 5
    assert kinds == ["stall", "trickle", "truncate", "garbage"]


def test_attempt_spans_bounded_by_wall_under_stall():
    def scenario(ka, tel, api):
        t = tel.Telemetry()
        client = ka.Client(api.url, timeout=5.0, attempt_deadline_s=0.2,
                           retry=fast_retry(ka), telemetry=t)
        code, _ = client.get(NS_PATH)
        client.close()
        events = tel.request_events(t.chrome_trace())
        assert all(float(e["dur"]) / 1e6 <= 0.5 for e in events), events
        return code, [e["args"]["status"] for e in events]
    assert both(scenario, chaos=[{"stall": 3.0, "count": 2}]) == \
        (404, [0, 0, 404])


def _serve_header_trickle(byte_interval_s):
    srv = socket.create_server(("127.0.0.1", 0))

    def run():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        conn.settimeout(5)
        try:
            conn.recv(65536)
            for ch in b"HTTP/1.1 200 OK\r\nx-padding: " + b"y" * 10_000:
                conn.sendall(bytes([ch]))
                time.sleep(byte_interval_s)
        except OSError:
            pass
        finally:
            conn.close()
            srv.close()

    threading.Thread(target=run, daemon=True).start()
    host, port = srv.getsockname()
    return f"http://{host}:{port}"


def test_header_trickle_bounded_by_watchdog_when_deadline_armed():
    results = []
    for ka, tel in SIDES:
        t = tel.Telemetry()
        client = ka.Client(_serve_header_trickle(0.05), timeout=5.0,
                           attempt_deadline_s=0.3, retry=ka.NO_RETRY,
                           telemetry=t)
        t0 = time.monotonic()
        code, body = client.get(NS_PATH)
        assert time.monotonic() - t0 < 2.0
        client.close()
        events = tel.request_events(t.chrome_trace())
        results.append((code, "deadline" in (body or {}).get("message", ""),
                        len(events), events[0]["args"].get("deadline")))
    assert results[1] == results[0] == (0, True, 1, True)


# ------------------------------------------------------- deadline budget


def test_budget_exhaustion_raises_typed_with_slowest_attempts():
    def scenario(ka, tel, api):
        client = ka.Client(
            api.url, timeout=0.3,
            retry=ka.RetryPolicy(attempts=50, base_s=0.02),
            budget=ka.DeadlineBudget(0.7), telemetry=tel.Telemetry())
        t0 = time.monotonic()
        with pytest.raises(ka.DeadlineExceeded) as err:
            client.get(NS_PATH)
        assert time.monotonic() - t0 < 2.5
        client.close()
        assert isinstance(err.value, ka.ApplyError)
        return ("slowest attempts" in str(err.value),
                bool(err.value.slowest_attempts))
    assert both(scenario, chaos=[{"stall": 0.5}], log=False) == (True, True)


def test_budget_clamps_backoff_sleeps():
    def scenario(ka, tel, api):
        client = ka.Client(
            api.url, timeout=0.5,
            retry=ka.RetryPolicy(attempts=10, base_s=2.0, cap_s=5.0,
                                 jitter=0.0),
            budget=ka.DeadlineBudget(0.5))
        t0 = time.monotonic()
        with pytest.raises(ka.DeadlineExceeded) as err:
            client.get(NS_PATH)
        assert time.monotonic() - t0 < 2.0
        client.close()
        return type(err.value).__name__
    assert both(scenario, chaos=[{"status": 503}]) == "DeadlineExceeded"


@pytest.mark.parametrize("watch", [False, True])
def test_budget_bounds_readiness_wait_with_typed_error(watch):
    ds = {"apiVersion": "apps/v1", "kind": "DaemonSet",
          "metadata": {"name": "slow-ds", "namespace": "gpu-system"},
          "spec": {"template": {"spec": {}}}}

    def scenario(ka, tel, api):
        client = ka.Client(api.url, retry=fast_retry(ka),
                           budget=ka.DeadlineBudget(0.3))
        client.apply(copy.deepcopy(ds))
        t0 = time.monotonic()
        with pytest.raises(ka.DeadlineExceeded) as err:
            client.wait_ready([ds], timeout=30, poll=0.05, watch=watch)
        assert time.monotonic() - t0 < 3.0
        client.close()
        return type(err.value).__name__
    assert both(scenario, log=False, auto_ready=False) == "DeadlineExceeded"


@pytest.mark.parametrize("budget", [None, 0.2])
def test_wait_crd_established_clamps_to_the_deadline(budget):
    crd_path = ("/apis/apiextensions.k8s.io/v1/"
                "customresourcedefinitions/foo.example.com")

    def scenario(ka, tel, api):
        api.store[crd_path] = {"kind": "CustomResourceDefinition",
                               "metadata": {"name": "foo.example.com"}}
        client = ka.Client(api.url, retry=ka.NO_RETRY,
                           budget=(ka.DeadlineBudget(budget)
                                   if budget else None))
        t0 = time.monotonic()
        with pytest.raises(ka.ApplyError) as err:
            if budget:
                client.wait_crd_established("foo.example.com", timeout=30,
                                            poll=0.05)
            else:
                client.wait_crd_established("foo.example.com",
                                            timeout=0.3, poll=30.0)
        assert time.monotonic() - t0 < 2.0
        client.close()
        return type(err.value).__name__, "timed out" in str(err.value)
    got = both(scenario, log=False, auto_ready=False)
    assert got[0] == ("DeadlineExceeded" if budget else "ApplyError")


def test_kubectl_kill_timer_and_rc124_stop_at_the_budget():
    for ka in (ref_kubeapply, kubeapply):
        assert ka._kubectl_timeout(600, None) == 720
        assert ka._kubectl_timeout(600, ka.DeadlineBudget(30)) <= 30
        assert ka._kubectl_timeout(600, ka.DeadlineBudget(0.0)) == 1.0
    calls = {}
    for ka, _tel in SIDES:
        seen = calls.setdefault(ka.__name__, [])

        def runner(argv, input_text=None, seen=seen):
            seen.append(list(argv))
            return 124, "", "killed after timeout"

        with pytest.raises(ka.DeadlineExceeded):
            ka.apply_groups_kubectl(
                [[{"apiVersion": "v1", "kind": "Namespace",
                   "metadata": {"name": "x"}}]], wait=False, runner=runner,
                retry=ka.RetryPolicy(attempts=5, base_s=0.01),
                budget=ka.DeadlineBudget(0.0))
    assert list(calls.values())[0] == list(calls.values())[1]
    assert len(list(calls.values())[1]) == 1


# ----------------------------------------------------------- hedged reads


def test_stalled_idempotent_read_triggers_exactly_one_hedge():
    def scenario(ka, tel, api):
        t = tel.Telemetry()
        client = ka.Client(api.url, timeout=2.0, retry=fast_retry(ka),
                           hedge_s=0.3, telemetry=t)
        t0 = time.monotonic()
        code, _ = client.get(NS_PATH)
        assert time.monotonic() - t0 < 1.5
        hedges_first = client.hedges
        client.get(NS_PATH)
        client.close()
        roles = sorted(e["args"]["hedge"]
                       for e in tel.request_events(t.chrome_trace())
                       if e["args"].get("hedge"))
        return (code, hedges_first, client.hedges,
                t.metrics.total(tel.HEDGES_TOTAL), "backup" in roles)
    assert both(scenario, chaos=[{"stall": 3.0, "count": 1,
                                  "method": "GET"}]) == (404, 1, 1, 1.0,
                                                         True)


def test_failed_backup_never_cancels_a_succeeding_primary():
    body = {"ok": 1}
    chaos = [{"count": 1, "method": "GET", "trickle": 20, "body": body},
             {"count": 1, "method": "GET", "drop": 1}]

    def scenario(ka, tel, api):
        client = ka.Client(api.url, timeout=2.0, attempt_deadline_s=1.5,
                           retry=ka.NO_RETRY, hedge_s=0.1)
        code, obj = client.get(NS_PATH)
        client.close()
        return code, obj, client.hedges
    assert both(scenario, chaos=chaos) == (200, body, 1)


def test_hedging_never_touches_mutations():
    def scenario(ka, tel, api):
        client = ka.Client(api.url, timeout=0.3, retry=fast_retry(ka),
                           hedge_s=0.25)
        verdict = client.apply({"apiVersion": "v1", "kind": "Namespace",
                                "metadata": {"name": "hedgeless"}})
        client.close()
        return verdict, client.hedges, client.retries >= 1
    assert both(scenario, chaos=[{"stall": 1.0, "count": 1,
                                  "method": "POST"}]) == ("created", 0,
                                                          True)


def _rollout(ka, api, groups, **client_kw):
    client = ka.Client(api.url, **client_kw)
    ka.apply_groups(client, groups, wait=True, stage_timeout=60,
                    poll=0.02, max_inflight=8, watch_ready=True)
    client.close()
    return client


def test_clean_rollout_with_hedging_armed_fires_no_hedges():
    groups = port_groups()

    def scenario(ka, tel, api):
        client = _rollout(ka, api, groups, hedge_s=0.5,
                          budget=ka.DeadlineBudget(300))
        return client.hedges
    assert both(scenario) == 0


def test_arming_the_discipline_changes_no_request():
    """No deadline or hedge against arming both on a healthy server: the
    same requests on each engine, and a warm re-apply mutates nothing."""
    groups = port_groups()

    def scenario(ka, tel, api):
        _rollout(ka, api, groups, attempt_deadline_s=5.0, hedge_s=0.5,
                 budget=ka.DeadlineBudget(300))
        cold = sum(n for (m, _p), n in wire(api).items() if m in MUTATING)
        _rollout(ka, api, groups, attempt_deadline_s=5.0, hedge_s=0.5,
                 budget=ka.DeadlineBudget(300))
        warm = sum(n for (m, _p), n in wire(api).items()
                   if m in MUTATING) - cold
        return warm
    assert both(scenario) == 0

    def requests(armed):
        def run(ka, tel, api):
            kw = dict(attempt_deadline_s=5.0, hedge_s=0.5,
                      budget=ka.DeadlineBudget(300)) if armed else {}
            _rollout(ka, api, groups, **kw)
            return wire(api)
        return run
    assert both(requests(True)) == both(requests(False))


def test_slow_fault_script_rollout_converges_to_the_clean_store():
    groups = port_groups(full=False)

    def store_of(api):
        return {p: o.get("kind") for p, o in api.snapshot().items()}

    def clean(ka, tel, api):
        _rollout(ka, api, groups)
        return store_of(api)

    def slow(ka, tel, api):
        client = _rollout(ka, api, groups, timeout=5.0,
                          attempt_deadline_s=0.15, hedge_s=0.06,
                          retry=fast_retry(ka))
        assert client.retries > 0
        return store_of(api)
    want = both(clean)
    assert both(slow, chaos=slow_fault_script(0.03), log=False) == want


# ------------------------------------------------------------ pagination


def test_paginated_list_chases_continue_tokens():
    def scenario(ka, tel, api):
        t = tel.Telemetry()
        client = ka.Client(api.url, retry=fast_retry(ka), telemetry=t)
        items, rv, pages = client.list_paged(NODES, 100)
        client.close()
        return (sorted(items), bool(rv), pages,
                t.metrics.total(tel.LIST_PAGES_TOTAL),
                api.list_pages.get(NODES, 0) >= 2)
    got = both(scenario, store=fleet_store(250, pods_per_node=0))
    assert len(got[0]) == 250 and got[2] == 3 and got[4]


def test_list_collection_page_limit_routes_through_the_chase():
    def scenario(ka, tel, api):
        client = ka.Client(api.url, retry=fast_retry(ka),
                           list_page_limit=50)
        items = client.list_collection(NODES)
        client.close()
        return sorted(items)
    assert len(both(scenario, store=fleet_store(120, pods_per_node=0))) \
        == 120


def test_expired_continue_token_answers_410_then_clean_relist():
    def scenario(ka, tel, api):
        client = ka.Client(api.url, retry=fast_retry(ka))
        code, first = client.get(f"{NODES}?limit=40")
        token = first["metadata"]["continue"]
        api.expire_continue_tokens()
        gone = client.get(f"{NODES}?limit=40&continue={token}")
        real_get = client.get
        expired_once = []

        def sabotage(path):
            if "continue=" in path and not expired_once:
                expired_once.append(True)
                api.expire_continue_tokens()
            return real_get(path)

        client.get = sabotage
        try:
            items, _rv, pages = client.list_paged(NODES, 40)
        finally:
            client.get = real_get
        client.close()
        return (code, gone[0], gone[1].get("reason"), bool(expired_once),
                sorted(items), pages)
    got = both(scenario, store=fleet_store(90, pods_per_node=0))
    assert got[:4] == (200, 410, "Expired", True)
    assert len(got[4]) == 90 and got[5] == 3


def test_every_token_expired_fails_loudly_not_forever():
    def scenario(ka, tel, api):
        client = ka.Client(api.url, retry=fast_retry(ka))
        with pytest.raises(ka.ApplyError, match="consecutive") as err:
            client.list_paged(NODES, 10)
        client.close()
        return str(err.value)
    both(scenario, continue_ttl_s=0.0,
         store=fleet_store(30, pods_per_node=0))


# ------------------------------------------------------------- APF / 429


@pytest.mark.parametrize("attempt,retry_after,policy", [
    (1, 0.5, dict(base_s=0.01, jitter=0.0)),
    (3, 0.5, dict(base_s=0.01, jitter=0.0)),
    (1, 10_000.0, dict(cap_s=1.0, jitter=0.0)),
    (4, 0.05, dict(base_s=1.0, cap_s=30.0, jitter=0.0)),
    (2, None, dict(base_s=0.1, cap_s=5.0, jitter=0.0)),
])
def test_retry_after_is_a_floor_not_an_appointment(attempt, retry_after,
                                                   policy):
    got = [ka.RetryPolicy(**policy).backoff_s(attempt,
                                              retry_after=retry_after)
           for ka in (ref_kubeapply, kubeapply)]
    assert got[1] == got[0]
    if retry_after is not None and policy.get("cap_s", 5.0) >= retry_after:
        assert got[1] >= retry_after
    jittered = kubeapply.RetryPolicy(base_s=0.01, jitter=0.2)
    assert all(jittered.backoff_s(a, retry_after=0.5) >= 0.5
               for a in (1, 2, 3))
    assert kubeapply.RetryPolicy(cap_s=1.0).backoff_s(
        1, retry_after=10_000.0) <= 1.0 * 1.2 + 1e-9


def test_apf_429_storm_absorbed_by_retry_family():
    """Eight threads over an inflight budget of two: how many requests
    are shed depends on thread timing, so each side's codes and its
    shedding are compared, not the wire multiset."""
    def scenario(ka, tel, api):
        client = ka.Client(api.url, retry=fast_retry(ka))
        with cf.ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(client.get, f"{NODES}/fleet-0001")
                    for _ in range(24)]
            codes = [f.result()[0] for f in futs]
        client.close()
        return (codes, api.apf_rejections > 0,
                "fake_apiserver_apf_rejections_total"
                in api.fake_metrics_text())
    assert both(scenario, log=False, latency_s=0.05, apf_inflight_budget=2,
                store=fleet_store(20, pods_per_node=0)) == \
        ([200] * 24, True, True)


def test_a_429_is_never_hedged():
    """Only the first attempt goes through the hedged path. The wire may
    carry a stale-socket re-send per attempt: the distinct requests are
    compared, and each side's count held to the reference's bound."""
    def scenario(ka, tel, api):
        client = ka.Client(api.url, hedge_s=0.0,
                           retry=ka.RetryPolicy(attempts=4, base_s=0.001,
                                                cap_s=0.01))
        hedged = []
        real = client._request_hedged

        def counting(method, path):
            hedged.append(path)
            return real(method, path)

        client._request_hedged = counting
        code, _ = client.get(f"{NODES}/fleet-0001")
        client.close()
        gets = [e for e in api.log if e[0] == "GET"]
        assert len(gets) <= 2 * 4 + 1, gets
        return code, len(hedged), sorted(set(gets))
    assert both(scenario, log=False, apf_inflight_budget=0,
                store=fleet_store(5, pods_per_node=0))[:2] == (429, 1)


# --------------------------------------------------- multiplexed transport


def test_mux_off_is_byte_identical_and_unpaginated():
    groups = port_groups(full=False)

    def scenario(mux):
        def run(ka, tel, api):
            _rollout(ka, api, groups, **({"mux": mux} if mux else {}))
            if not mux:
                assert not any("limit=" in p for _, p in api.log)
            return wire(api)
        return run
    baseline = both(scenario(0))
    muxed = both(scenario(4))
    assert muxed == baseline
    assert sorted(k for k in muxed.elements() if k[0] in MUTATING) == \
        sorted(k for k in baseline.elements() if k[0] in MUTATING)


def test_mux_socket_count_is_o_pool_not_o_threads():
    def scenario(ka, tel, api):
        client = ka.Client(api.url, mux=3, retry=fast_retry(ka))
        with cf.ThreadPoolExecutor(16) as ex:
            futs = [ex.submit(client.get, f"{NODES}/fleet-0002")
                    for _ in range(96)]
            codes = {f.result()[0] for f in futs}
        assert client._mux_transport.max_open <= 3
        client.close()
        off = ka.Client(api.url)
        assert off._mux_transport is None
        off.close()
        return codes
    assert both(scenario, store=fleet_store(10, pods_per_node=0)) == {200}


def _serve_204_twice(served):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        with conn:
            for _ in range(2):
                req = b""
                while b"\r\n\r\n" not in req:
                    chunk = conn.recv(4096)
                    if not chunk:
                        return
                    req += chunk
                served.append(req.split(b" ", 2)[1])
                conn.sendall(b"HTTP/1.1 204 No Content\r\n\r\n")

    helper = threading.Thread(target=serve, daemon=True)
    helper.start()
    return srv, helper


def test_mux_bodyless_204_returns_without_eof_wait():
    results = []
    for mod in (ref_muxhttp, muxhttp):
        served = []
        srv, helper = _serve_204_twice(served)
        transport = mod.MuxTransport(
            f"http://127.0.0.1:{srv.getsockname()[1]}", pool_size=1,
            timeout=2.0)
        try:
            t0 = time.monotonic()
            answers = [transport.request("GET", path, {}, None,
                                         wall_s=2.0)
                       for path in ("/a", "/b")]
            assert time.monotonic() - t0 < 1.5
            results.append(([(s, p) for s, _h, p in answers], served,
                            transport.opened))
        finally:
            transport.close()
            srv.close()
            helper.join(timeout=5)
    assert results[1] == results[0] == ([(204, b""), (204, b"")],
                                        [b"/a", b"/b"], 1)
