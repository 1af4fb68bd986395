"""The port's collectives (``workloads/collectives.py``) against the JAX
reference: the collective matrix over four gloo ranks (one process
each, the counterpart of the reference's virtual 8-device mesh), the
one-rank group when none is up, the bandwidth results' keys, and two
real processes bootstrapped by ``multihost.initialize`` under the
Indexed-Job env running ``validate --mode=psum``, with one rank each and
with two ranks each (one rank a card across hosts)."""

import contextlib
import io
import json
import sys

import pytest
import torch.distributed as dist

from test_multihost_bootstrap import run_two_workers
from tpu_cluster.workloads import collectives as ref
from tpu_cluster_torch.workloads import collectives, validate

RANKS = 4


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One validate run whose psum spans four gloo ranks (its JSON and
    its metrics file), and psum_check over four ranks."""
    path = tmp_path_factory.mktemp("metrics") / "m.prom"
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_METRICS_FILE", str(path))
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = validate.main(["--mode=psum", f"--psum-devices={RANKS}",
                                "--device=cpu"])
    finally:
        mp.undo()
    doc = json.loads(out.getvalue())
    psum = collectives.run_ranks(RANKS, collectives.psum_check, RANKS,
                                 device="cpu")
    return rc, doc, path.read_text(), psum


def test_collective_matrix_over_four_gloo_ranks(four_ranks):
    rc, doc, _, _ = four_ranks
    assert rc == 0 and doc["ok"], doc
    assert doc["devices"] == RANKS
    for key in ("psum_ok", "all_gather_ok", "reduce_scatter_ok",
                "ppermute_ok"):
        assert doc[key] is True, key


def test_matrix_keys_match_reference(four_ranks):
    _, doc, _, _ = four_ranks
    want = ref.collective_matrix(RANKS)
    assert want["ok"]
    assert set(doc) - {"mode", "bootstrap", "metrics_file"} == set(want)


def test_psum_expected_matches_reference(four_ranks):
    *_, psum = four_ranks
    want = ref.psum_check(RANKS)
    assert psum == {"check": "psum", "devices": RANKS,
                    "expected": want["expected"], "ok": True}
    assert set(psum) == set(want)


def test_ranks_busy_time_reaches_the_duty_gauge(four_ranks):
    """Rank 0 measures its device-busy regions in its own process; the
    validate process publishes them."""
    _, _, metrics, _ = four_ranks
    assert 'tpu_duty_cycle_percent{chip="0"}' in metrics


def test_one_rank_group_when_none_is_up():
    doc = collectives.collective_matrix(device="cpu")
    assert doc == {"devices": 1, "all_gather_ok": True,
                   "reduce_scatter_ok": True, "ppermute_ok": True,
                   "psum_ok": True, "ok": True}
    assert set(doc) == set(ref.collective_matrix(1))
    assert collectives.psum_check(device="cpu")["expected"] == \
        ref.psum_check(1)["expected"] == 0.0
    assert not dist.is_initialized()  # the trivial group is torn down


def test_device_count_must_match_the_group():
    with pytest.raises(ValueError, match="requested 2 devices"):
        collectives.collective_matrix(2, device="cpu")
    assert not dist.is_initialized()


def test_global_psum_keys_match_reference():
    got = collectives.global_psum_check(device="cpu")
    want = ref.global_psum_check()
    assert set(got) == set(want)
    assert got["ok"] and want["ok"]
    assert (got["devices"], got["processes"], got["total"]) == (1, 1, 0.0)


@pytest.mark.parametrize("op", ["all_reduce", "all_gather"])
def test_bus_bandwidth_keys_match_reference(op):
    """One rank moves nothing over a bus: both formulas give 0."""
    got = collectives.bus_bandwidth(op, mib=0.25, iters=2, reps=1,
                                    device="cpu")
    want = ref.bus_bandwidth(op, n_devices=1, mib=0.25, iters=2, reps=1)
    outcome = {"busbw_spread", "note"}
    assert set(got) - outcome == set(want) - outcome
    assert got["busbw_gib_s"] == want["busbw_gib_s"] == 0.0
    with pytest.raises(ValueError, match="unknown collective op"):
        collectives.bus_bandwidth("broadcast", device="cpu")


def test_ici_roofline_and_allreduce_bandwidth_keys_match_reference():
    got = collectives.ici_roofline(mib=0.25, iters=2, reps=1, device="cpu")
    want = ref.ici_roofline(n_devices=1, mib=0.25, iters=2, reps=1)
    assert set(got) == set(want)  # no link rate on the CPU, on either side
    got = collectives.allreduce_bandwidth(mib=1, iters=2, device="cpu")
    want = ref.allreduce_bandwidth(n_devices=1, mib=1, iters=2)
    assert set(got) == set(want) and got["busbw_gib_s"] == 0.0


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="requested 3 devices"):
        collectives.run_ranks(2, collectives.collective_matrix, 3,
                              device="cpu")


def test_two_process_global_psum_via_validate_job():
    """Two pods of an Indexed Job, each one process and one gloo rank,
    joined by multihost.initialize, run the Job's entry point."""
    results = run_two_workers(
        [sys.executable, "-m", "tpu_cluster_torch.workloads.validate",
         "--mode=psum", "--device=cpu"])
    for idx, (rc, out, err, port) in enumerate(results):
        assert rc == 0, f"worker {idx} failed:\n{err[-2000:]}"
        doc = json.loads(out[out.index("{"):])
        assert doc["ok"], doc
        assert doc["devices"] == 2
        for key in ("psum_ok", "all_gather_ok", "reduce_scatter_ok",
                    "ppermute_ok"):
            assert doc[key] is True, (key, doc)
        gp = doc["global_psum"]
        assert gp["ok"] and gp["processes"] == 2
        assert gp["process_index"] == idx
        assert gp["total"] == 1.0  # sum(0..1) over both processes
        assert doc["bootstrap"]["process_id"] == idx
        assert doc["bootstrap"]["coordinator_address"] == f"127.0.0.1:{port}"


def test_two_process_device_query_counts_every_worker():
    """Multi-host device-query checks the assembled Job: each worker's
    local count and the global count summed over the group."""
    results = run_two_workers(
        [sys.executable, "-m", "tpu_cluster_torch.workloads.validate",
         "--mode=device-query", "--device=cpu", "--expect-devices=1"])
    for idx, (rc, out, err, _) in enumerate(results):
        assert rc == 0, f"worker {idx} failed:\n{err[-2000:]}"
        doc = json.loads(out[out.index("{"):])
        assert doc["ok"], doc
        assert doc["process_index"] == idx
        assert (doc["local_device_count"], doc["expected_global_devices"],
                doc["global_device_count"]) == (1, 2, 2)


def test_two_hosts_of_two_ranks_psum_over_four():
    """Two pods of an Indexed Job with two devices each start a rank per
    device; rank = host index x 2 + local index, and the global psum and
    the collective matrix span all four."""
    results = run_two_workers(
        [sys.executable, "-m", "tpu_cluster_torch.workloads.validate",
         "--mode=psum", "--device=cpu", "--psum-devices=2"])
    for idx, (rc, out, err, _) in enumerate(results):
        assert rc == 0, f"worker {idx} failed:\n{err[-2000:]}"
        doc = json.loads(out[out.index("{"):])
        assert doc["ok"] and doc["devices"] == 4, doc
        gp = doc["global_psum"]
        assert gp["ok"] and gp["processes"] == gp["devices"] == 4
        assert gp["total"] == 6.0  # sum(0..3) over every rank
        # the pod prints its first rank's document
        assert gp["process_index"] == doc["bootstrap"]["rank"] == 2 * idx
        assert doc["bootstrap"]["world_size"] == 4
        assert doc["bootstrap"]["local_rank"] == 0
