"""The latency controller on a mesh: llama3.2-1b's meshed scheduler engine
at (data, model) = (2, 2) on a gloo world of 4 ranks with
``ControllerConfig`` on, its steps on the CPU graph stand-in, against
``repro``'s meshed scheduler engine with the same controller on 4 fake
devices.

Targets every step and first token crosses make the controller shrink as
soon as its windows hold ``min_samples`` readings.  Rank 0's controller
decides and every rank applies its decision at the same tick, so the
decision logs (tick, decision, slot cap, watermark) are equal on every
rank even though each rank's clock and windows are its own; half the
requests arrive after ``start()``, at each rank's own pace.  llama3.2-1b
is dense, so the controller's limits do not change its greedy tokens:
every rank's equal ``repro``'s per request, and none is dropped.
"""

import itertools

import pytest

import torch_mesh_handler_cases as H


@pytest.fixture(autouse=True)
def _fresh_lock_ids(monkeypatch):
    """Start both packages' lock-id counters at 1, as
    tests/test_torch_figures.py does."""
    for mod in H.lock_id_counters():
        monkeypatch.setattr(mod, "_lock_ids", itertools.count(1))


@pytest.fixture(scope="module")
def world():
    return H.run_controller_world(H.params_np(H.CTRL_ARCH))


def test_the_controller_decides_on_a_mesh(world):
    _, ranks = world
    log = ranks[0]["log"]
    assert any(d == "shrink" for _, d, _, _ in log)
    assert ranks[0]["slot_cap"] < H.CTRL_SCHED["max_slots"]


def test_every_rank_logs_the_same_decisions(world):
    _, ranks = world
    first = ranks[0]["log"]
    for r in ranks[1:]:
        assert r["log"] == first
        assert r["slot_cap"] == ranks[0]["slot_cap"]


def test_no_request_is_dropped(world):
    _, ranks = world
    for r in ranks:
        assert all(r["done"])
        assert all(len(t) == H.CTRL_TOKENS for t in r["tokens"])
        assert r["free_after"] == 128


def test_tokens_equal_repros_meshed_engine_on_every_rank(world):
    oracle, ranks = world
    for r in ranks:
        assert r["tokens"] == oracle["tokens"]
