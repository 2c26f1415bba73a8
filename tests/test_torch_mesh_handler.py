"""The meshed engine's handler mode: the port on gloo worlds of 4 ranks
against ``repro``'s handler engine on 4 fake devices, at the float32 smoke
configs of phi3.5-moe, llama4-maverick (its own rules: seqshard
attention), rwkv6, zamba2 and llama3.2-1b, each under its config's rules,
at (data, model) = (2, 2) and (1, 4).

* Eight requests queued before ``start()``: two batches of four rows,
  which the data axis divides.  ``repro`` serves them with one handler
  thread; the port with one and with two, whose steps take turns.  Every
  rank's tokens equal ``repro``'s per request.
* Identity hot swaps on each rank's own period: the tokens stay
  ``repro``'s on every rank.
* Perturbing swaps staged at each rank's own moments, the graphs on the
  CPU stand-in, then a second wave of the requests on the settled tree:
  every rank installs each swap after the same number of turns, serves
  the same tokens, and its handler steps warm up, capture and replay
  alike.
* R17: at (2, 2) a 3-row phi3.5-moe batch fails in the MoE layer on both
  sides: ``EngineFailure`` wrapping ``ValueError`` at ``stop()``.
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
def worlds():
    params = {a: H.params_np(a) for a in H.HANDLER_ARCHS}
    return H.run_handler_worlds(params)


CASES = [(m, a, n) for m in H.HANDLER_MESHES for a in H.HANDLER_ARCHS
         for n in (1, 2)]


@pytest.mark.parametrize("mesh,arch,handlers", CASES)
def test_handler_tokens_equal_repros(worlds, mesh, arch, handlers):
    oracle, ranks = worlds
    want = oracle[(arch, mesh)]
    assert all(len(t) == H.MAX_NEW for t in want)
    for r in ranks[mesh]:
        assert r["tokens"][(arch, handlers)] == want


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in H.HANDLER_MESHES
                                       for a in H.HANDLER_ARCHS])
def test_identity_swaps_keep_repros_tokens_on_every_rank(worlds, mesh,
                                                          arch):
    oracle, ranks = worlds
    first = ranks[mesh][0]["identity"][arch]
    for r in ranks[mesh]:
        got = r["identity"][arch]
        assert got["tokens"] == oracle[(arch, mesh)]
        assert got["landed"] == first["landed"]
        assert got["swaps"] == first["swaps"] == len(first["landed"])


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in H.HANDLER_MESHES
                                       for a in H.SWAP_ARCHS])
def test_perturbing_swaps_land_on_the_same_turn_on_every_rank(worlds, mesh,
                                                               arch):
    _, ranks = worlds
    first = ranks[mesh][0]["swaps"][arch]
    assert first["swaps"] == len(first["landed"]) == H.SWAPS
    assert len(first["tokens"]) == 2 * len(H.LENS)
    assert all(len(t) == H.MAX_NEW for t in first["tokens"])
    for r in ranks[mesh][1:]:
        got = r["swaps"][arch]
        assert got["landed"] == first["landed"]
        assert got["tokens"] == first["tokens"]


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in H.HANDLER_MESHES
                                       for a in H.SWAP_ARCHS])
def test_handler_graph_decisions_are_equal_on_every_rank(worlds, mesh,
                                                         arch):
    _, ranks = worlds
    first = ranks[mesh][0]["swaps"][arch]["graphs"]
    assert sorted(first) == ["h0_b4", "h1_b4"]
    for steps in first.values():
        # the decode steps of the second wave, on the settled tree,
        # capture and replay
        assert steps["prefill"]["warmups"] >= 1
        assert steps["decode"]["captures"] >= 1
        assert steps["decode"]["replays"] >= 1
        for st in steps.values():
            st.pop("capture_ms")
    for r in ranks[mesh][1:]:
        got = r["swaps"][arch]["graphs"]
        for steps in got.values():
            for st in steps.values():
                st.pop("capture_ms")
        assert got == first


def test_r17_batch_fails_in_the_moe_layer_as_in_repro(worlds):
    """Three rows over a data axis of 2: ``repro``'s shard_map and the
    port's MoE layer refuse the decode step's rows alike; the handler
    thread dies, its requests stay undone, and ``stop()`` raises."""
    oracle, ranks = worlds
    assert [t for t, _ in oracle["r17"]] == ["ValueError"]
    assert "does not evenly divide" in oracle["r17"][0][1]
    assert not any(oracle["r17_done"])
    for r in ranks["2x2"]:
        assert [t for t, _ in r["r17"]] == ["ValueError"]
        assert "do not evenly divide 3" in r["r17"][0][1]
        assert not any(r["r17_done"])
