"""The run's host: the card's local CPUs and the other notes each run
prints, the saturated sender's pace, and cell 3's pool."""

from __future__ import annotations

import threading
import time

import pytest

from portbench import harness, host, serve, traffic
from portbench.tests.tiny import run_tiny, tiny_cell

SATURATED = harness.load_cell("mpt7b8k-serve-offline").traffic


@pytest.mark.parametrize("text, cpus", [
    ("0-31,64-95\n", set(range(32)) | set(range(64, 96))),
    ("7\n", {7}),
    ("0-3,8,10-11", {0, 1, 2, 3, 8, 10, 11}),
    ("\n", set()),
])
def test_cpulist_parses_and_spells_back(text, cpus):
    assert host.parse_cpulist(text) == cpus
    assert host.parse_cpulist(host.cpulist(cpus)) == cpus


@pytest.mark.parametrize("allowed, text, want", [
    (set(range(16)), "0-7", "0-7"),
    ({4, 5, 40, 41}, "0-31,64-95", "4-5"),
    (set(range(8)), "7", "7"),
    (set(range(8)), "", "none"),
    (set(range(8)), "32-63", "none"),
    (set(range(8)), None, "none"),
])
def test_card_local_cpus_within_the_allowed(allowed, text, want):
    assert host.local_allowed(allowed, text).split(":")[0] == want


def _fake_card(tmp_path, monkeypatch, text):
    address = "0000:1b:00.0"
    driver = tmp_path / "driver"
    (driver / address).mkdir(parents=True)
    (driver / "module").mkdir()
    (tmp_path / "devices" / address).mkdir(parents=True)
    if text is not None:
        (tmp_path / "devices" / address / "local_cpulist").write_text(text)
    monkeypatch.setattr(host, "NVIDIA_DRIVER", driver)
    monkeypatch.setattr(host, "PCI_DEVICES", tmp_path / "devices")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(host.os, "sched_getaffinity", lambda pid: {0, 1, 2, 3})
    calls = []
    monkeypatch.setattr(host.os, "sched_setaffinity",
                        lambda pid, cpus: calls.append((pid, set(cpus))))
    return address, calls


@pytest.mark.parametrize("text, local, allowed", [
    ("2-5\n", "2-5", "2-3"),
    (None, "unread", "none: the card's local_cpulist is unreadable"),
    ("", "", "none: the card's CPUs - share none with the allowed 0-3"),
    ("8-15", "8-15", "none: the card's CPUs 8-15 share none with the "
                     "allowed 0-3"),
])
def test_placement_notes_the_card_cpus_and_moves_nothing(tmp_path,
                                                         monkeypatch, text,
                                                         local, allowed):
    address, calls = _fake_card(tmp_path, monkeypatch, text)
    assert host.card_address() == address
    assert host.placement() == {"cpus_allowed": "0-3", "card_pci": address,
                                "card_local_cpus": local,
                                "card_local_allowed": allowed}
    assert calls == []


def test_placement_without_a_card_says_so(monkeypatch, tmp_path):
    monkeypatch.setattr(host, "NVIDIA_DRIVER", tmp_path / "missing")
    notes = host.placement()
    assert notes["card_pci"] == "not found"
    assert notes["card_local_allowed"].startswith("none")


class _Req:
    def __init__(self) -> None:
        self.done = threading.Event()


class _FakeEngine:
    """A queue that one request leaves every ``every_s``."""

    def __init__(self, every_s: float) -> None:
        self.lock = threading.Lock()
        self.queued = 0
        self.decoded_tokens = 0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._admit, args=(every_s,),
                                       daemon=True)

    def submit(self, prompt, max_new_tokens, deadline_s):
        with self.lock:
            self.queued += 1
        return _Req()

    def queue_depth(self) -> int:
        with self.lock:
            return self.queued

    def _admit(self, every_s: float) -> None:
        while not self.stop.wait(every_s):
            with self.lock:
                if self.queued:
                    self.queued -= 1
                    self.decoded_tokens += 100


def test_saturated_sender_holds_the_queue_and_wakes_at_its_pace():
    eng = _FakeEngine(every_s=0.05)
    plan = [traffic.Planned(0.0, (1, 2), 4)] * 1000
    sender = serve.Sender(eng, plan, 60.0, depth=4)
    sender.start()
    eng.thread.start()
    try:
        while eng.queue_depth() < 4:
            time.sleep(0.005)
        sender.mark()
        w0, t0 = sender.wakeups, time.monotonic()
        time.sleep(1.0)
        wakeups, window = sender.wakeups - w0, time.monotonic() - t0
        least = sender.least_depth
    finally:
        sender.stop.set()
        eng.stop.set()
        sender.join(timeout=5)
        eng.thread.join(timeout=5)
    assert not sender.is_alive() and sender.error is None
    # one admission every 50 ms: the queue never emptied
    assert least >= 1
    assert 10 <= len(sender.sent) - 4 <= 30
    # no more wake-ups than the window holds periods
    assert wakeups <= window / serve.Sender.POLL_S + 2


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_a_larger_pool_keeps_the_first_requests(seed):
    """Cell 3's streams draw in order: a larger pool sends the same first
    requests, ids included."""
    small = traffic.plan(dict(SATURATED, requests=400), seed, 51, 50432, 8192)
    large = traffic.plan(dict(SATURATED, requests=1100), seed, 51, 50432,
                         8192)
    assert len(small) == 400 and len(large) == 1100
    assert large[:400] == small


def test_cell3_pool_outlasts_the_window_well_past_todays_rate():
    """At the mix's mean answer the pool holds a 51 s window up to three
    times the fastest rate read on the card (1,871 tokens/s)."""
    plan = traffic.plan(SATURATED, 5, 51, 50432, 8192)
    tokens = sum(p.max_new for p in plan[8:])
    assert tokens / 51 > 3 * 1871


def test_an_exhausted_pool_says_at_what_rate():
    cell = tiny_cell("mpt7b8k-serve-offline", seconds=2.0)
    cell.traffic = dict(cell.traffic, requests=10)
    with pytest.raises(RuntimeError, match=r"ran out .* decoded tokens/s"):
        run_tiny(cell)


@pytest.mark.parametrize("name", ["mpt7b8k-serve-offline",
                                  "gptj6b-serve-poisson"])
def test_a_serving_run_carries_the_host_notes(name):
    out = run_tiny(tiny_cell(name))
    notes = out["notes"]
    for key in ("host_cpu", "host_mhz", "loadavg", "card_clock_power",
                "cpus_idle_share", "cpus_steal_s", "gc_runs_by_generation",
                "gc_pause_s", "thread_main", "thread_engine", "thread_sender",
                "threads_cpu_s", "engine_iterations", "sender_wakeups"):
        assert key in notes, key
    assert notes["engine_iterations"] > 0
    assert {"last_cpu", "cpu_s"} <= set(notes["thread_engine"])
    assert len(notes["gc_runs_by_generation"]) == 3
    if name == "mpt7b8k-serve-offline":
        assert notes["least_queue_depth"] >= 0
    else:
        assert "least_queue_depth" not in notes
