"""A whole run on the CPU at toy sizes, the card check skipped, with the
timed path broken underneath: ``correct`` comes out false for each fault
a cell can have, and true for the sound run.

Training: a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest; one leaf's update altered where
the step produces it; a step that goes wrong only once set-up's calls
are over, so in the window alone. Serving: a served token altered where the decode
produces it; a decode that returns its state unchanged; half of the
slots left out. One card: there is no exchange between chips to leave
out."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.tests.tiny import run_tiny, tiny_cell

MEDIUM = dict(d_model=256, n_heads=2, d_head=128, d_ff=1024, vocab=4096,
              context=512, layers=1)
TRAIN_CELLS = ["mpt7b8k-train-s8192", "gptj6b-train-s2048"]
SERVE_CELLS = ["gptj6b-serve-poisson", "mpt7b8k-serve-offline"]


def _numbers(out):
    return {k: c["value"] for k, c in out["checks"].items()}


@pytest.fixture
def burnin():
    from tpu_cluster_torch.workloads import burnin
    return burnin


@pytest.fixture
def serving():
    from tpu_cluster_torch.workloads import serving
    return serving


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_sound_run_is_correct(name):
    out = run_tiny(tiny_cell(name))
    assert out["attempted"] > 0 and out["failed"] == 0
    assert max(_numbers(out).values()) < 3e-3


def _unchanged(burnin, monkeypatch):
    step = burnin.train_step

    def fake(params, batch, cfg, **kw):
        return params, step(params, batch, cfg, **kw)[1]
    monkeypatch.setattr(burnin, "train_step", fake)


def _half_batch(burnin, monkeypatch):
    xent = burnin.softmax_xent

    def fake(logits, targets):
        half = logits.shape[0] // 2
        return xent(logits[:half], targets[:half])
    monkeypatch.setattr(burnin, "softmax_xent", fake)


def _update_altered(burnin, monkeypatch):
    update = burnin.sgd_update

    def fake(params, grads, lr):
        grads = dict(grads, wo=2 * grads["wo"])
        return update(params, grads, lr)
    monkeypatch.setattr(burnin, "sgd_update", fake)


def _unchanged_in_window(burnin, monkeypatch):
    """A path that takes over after the warm-up's calls, as a fast path
    that starts after N calls would: sound in set-up, unchanged state in
    the window."""
    step = burnin.train_step
    calls = []

    def fake(params, batch, cfg, **kw):
        calls.append(1)
        new, loss = step(params, batch, cfg, **kw)
        return (params if len(calls) > WARM_CALLS else new), loss
    monkeypatch.setattr(burnin, "train_step", fake)


WARM_CALLS = 5


@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _update_altered,
                                   _unchanged_in_window],
                         ids=["state_unchanged", "half_batch",
                              "update_altered", "unchanged_in_window"])
def test_training_fault_is_not_correct(name, fault, burnin, monkeypatch):
    sound = _numbers(run_tiny(tiny_cell(name)))
    assert tiny_cell(name).traffic["warm_steps"] == WARM_CALLS
    fault(burnin, monkeypatch)
    out = run_tiny(tiny_cell(name))
    assert out["correct"] is False
    assert any(v >= 10 * sound[k] for k, v in _numbers(out).items())


def _serve_cell(name, busy=False):
    """``busy``: arrivals above what the toy engine serves, so that every
    slot is seated and a fault in any slot reaches the judged sample."""
    cell = tiny_cell(name)
    cell.config["model"] = dict(MEDIUM)
    if busy and cell.traffic["kind"] == "open":
        cell.traffic["arrivals"] = dict(cell.traffic["arrivals"],
                                        rate_per_s=300.0)
    return cell


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serving_sound_run_is_correct(name):
    out = run_tiny(_serve_cell(name))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0


def _wrap_decode(serving, monkeypatch, alter):
    make = serving.make_decode

    def fake(mcfg, device):
        decode = make(mcfg, device)
        state = {}

        def broken(params, tokens, pos):
            return alter(np.array(decode(params, tokens, pos)), state, mcfg)
        return broken
    monkeypatch.setattr(serving, "make_decode", fake)


def _token_altered(ids, state, mcfg):
    ids[0] = (ids[0] + 1) % mcfg.vocab
    return ids


def _state_unchanged(ids, state, mcfg):
    return state.setdefault("first", ids).copy()


def _half_slots(ids, state, mcfg):
    ids[len(ids) // 2:] = 0
    return ids


@pytest.mark.parametrize("name", SERVE_CELLS)
@pytest.mark.parametrize("alter", [_token_altered, _state_unchanged,
                                   _half_slots],
                         ids=["token_altered", "state_unchanged",
                              "half_slots"])
def test_serving_fault_is_not_correct(name, alter, serving, monkeypatch):
    _wrap_decode(serving, monkeypatch, alter)
    out = run_tiny(_serve_cell(name, busy=True))
    assert out["correct"] is False, out["checks"]
