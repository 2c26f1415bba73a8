"""The graphed meshed paths' agreement across ranks, on gloo worlds of 2
and 4 ranks with the graphs on the CPU stand-in (the capture runs the
step and restores its arguments, a replay runs it again):

* ``GraphedStep`` with the world's host group, whose step sums over the
  world (a collective, as the paged steps' all-gathers are), called while
  each rank's own swap thread replaces the parameter tree at its own
  random moments: every rank takes every call the same way (warm-up,
  capture or replay), so the collectives pair up and the stats agree.
  Without the agreement a rank whose tree changed warms up while a peer
  replays, and the graphs' collectives fall out of step (ROADMAP R16).
* The meshed scheduler engine with each rank's updater on its own period:
  each swap lands on the same agreement round on every rank, the paged
  steps' stats are equal on every rank, and so are the tokens.
"""

import pytest

import torch_mesh_cases as C

WORLDS = (2, 4)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def decisions(request):
    return C.run_ranks("rank_graph_decisions", request.param, 7)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def swaps(request):
    return C.run_ranks("rank_engine_swaps", request.param, 0)


def test_every_rank_takes_every_call_the_same_way(decisions):
    first = decisions[0]
    for r in decisions[1:]:
        assert r["kinds"] == first["kinds"]
        assert r["stats"] == first["stats"]
        assert r["sums"] == first["sums"]


def test_each_swap_costs_every_rank_a_warmup(decisions):
    """Each of a rank's swaps made every rank warm up (swaps of two ranks
    seen on one call share it), each capture followed a warm-up of the
    call before, and the settled trees were captured and replayed."""
    kinds = decisions[0]["kinds"]
    assert kinds[0] == "warmup"
    assert kinds.count("warmup") >= 1 + C.GRAPH_SWAPS
    for i, k in enumerate(kinds):
        if k == "capture":
            assert kinds[i - 1] == "warmup", kinds
    assert "capture" in kinds[-C.GRAPH_CALLS:] and kinds[-1] == "replay"


def test_engine_lands_each_swap_on_the_same_round(swaps):
    first = swaps[0]
    assert first["swaps"] >= 1 and len(first["landed"]) == first["swaps"]
    for r in swaps[1:]:
        assert r["landed"] == first["landed"]
        assert r["swaps"] == first["swaps"]


def test_engine_step_stats_are_equal_on_every_rank(swaps):
    first = swaps[0]
    assert first["decode"][0] >= 1
    for r in swaps[1:]:
        assert r["decode"] == first["decode"]
        assert r["prefill"] == first["prefill"]


def test_engine_tokens_are_equal_on_every_rank(swaps):
    first = swaps[0]
    assert all(len(t) == C.ENGINE_TOKENS for t in first["tokens"])
    for r in swaps[1:]:
        assert r["tokens"] == first["tokens"]
