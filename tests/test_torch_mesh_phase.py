"""``chip_smoke.py``'s ``mesh`` phase, one set of checks for one rank and
for several: ``_mesh_checks`` (what ``_mesh_rank`` runs once it has
started the rank's world) on gloo worlds of 1 and 2 ranks at the smoke
configs, the graphs on the CPU stand-in, then ``_mesh_across`` over the
ranks' records.  Each rank runs the graphed meshed engine against its
bare steps under swaps and without, both revokes, the compressed
all-reduce, the twins' sections, phi3.5-moe's MoE layer with its experts
over "model" and the train step at each of ``_mesh_shapes``' meshes
(expert-parallel where "model" is above 1), eager and graphed, and the
sharded train step (one rank: bit for bit the unsharded step; two: at
(data, model) = (2, 1) against the unsharded step at float32 and bf16
compute, then eager and graphed at more layers), and the sharded serving
steps (one rank: bit for bit the unsharded steps; two: against the
unsharded steps at both precisions, the decode step eager and graphed,
the long prefill); across ranks the tokens, graph stats, losses and
sampled parameters must be equal.  On
the card the same functions run over NCCL, one rank a card."""

import os
import sys

import pytest

import torch_mesh_cases as C

sys.path.insert(0, os.path.dirname(C.SRC))
import chip_smoke as CS  # noqa: E402


@pytest.fixture(scope="module", params=(1, 2), ids=lambda w: f"{w}ranks")
def phase(request):
    world = request.param
    recs = C.run_ranks("rank_mesh_phase", world)
    return world, recs, CS._mesh_across(recs)


def test_phase_checks_hold_across_ranks(phase):
    world, recs, out = phase
    assert out["ranks_equal"] and out["world"]["ranks"] == world
    assert [r["rank"] for r in out["per_rank"]] == list(range(world))


def test_phase_runs_its_meshes(phase):
    world, _, out = phase
    shapes = CS._mesh_shapes(world)
    assert out["engine"]["mesh"] == dict(zip(shapes["engine"][1],
                                            shapes["engine"][0]))
    assert [t["mesh"] for t in out["train"]] == [
        dict(zip(n, s)) for s, n in shapes["train"]]
    assert [t["expert_parallel"] for t in out["train"]] == [
        s[1] > 1 for s, _ in shapes["train"]]


def test_phase_engine_graphs_swap_and_capture(phase):
    """Every run under swaps landed some, none without; the graphed run
    without swaps captured its decode step and replayed it."""
    _, _, out = phase
    runs = out["engine"]["runs"]
    assert all((r["weight_swaps"] >= 1) == r["swaps"] for r in runs)
    still = [r for r in runs if r["arm"] == "graph" and not r["swaps"]]
    assert [r["steps"]["decode"]["captures"] for r in still] == [1]
    assert still[0]["steps"]["decode"]["replays"] >= 1


def test_phase_train_graph_equals_eager(phase):
    _, _, out = phase
    for t in out["train"]:
        assert t["losses"]["graph"] == t["losses"]["eager"]
        assert t["graph_stats"]["captures"] == 1


def test_phase_issues_every_collective_kind(phase):
    _, recs, _ = phase
    for r in recs:
        assert {"all_reduce", "all_gather", "all_to_all"} <= set(
            r["collectives"])


def test_phase_sharded_step(phase):
    """One rank: the sharded step's every leaf equals the unsharded
    step's.  More: the checks against the unsharded step ran at both
    precisions, the graphed deep arm equals the eager one, and the trees
    each arm returns after its last step hold the bytes the rank's specs
    give it, less than the whole state."""
    world, recs, _ = phase
    for r in recs:
        sh = r["sharded"]
        if world == 1:
            assert sh["leaves_differ"] == []
            assert sh["loss"][0] == sh["loss"][1]
            continue
        assert sh["mesh"] == {"data": 2, "model": world // 2}
        for k in ("check_float32", "check_bfloat16"):
            assert sh[k]["max_update_err_over_bound"] <= 1.0
        deep = sh["deep"]
        assert deep["losses"]["graph"] == deep["losses"]["eager"]
        kept = deep["stored_bytes"]
        assert kept["eager"] == kept["graph"] == deep["spec_bytes"] \
            < deep["whole_state_bytes"]["params_m_v"]
        assert {"all_gather", "reduce_scatter", "all_reduce"} <= set(
            sh["collectives"])


def test_phase_sharded_serving_steps(phase):
    """One rank: the sharded prefill and decode steps equal the unsharded
    ones bit for bit, eager and graphed.  More: both precisions' checks
    held, the graphed decode step equals the eager one with the cache
    blocks' bytes the specs' count, the long prefill's cache blocks
    likewise, and the path launched none of the port's kernels."""
    world, recs, _ = phase
    for r in recs:
        sv = r["sharded_serve"]
        assert not any(sv["kernel_launches"].values())
        if world == 1:
            assert sv["differ"] == []
            continue
        assert {"check_float32", "check_bfloat16"} <= set(sv)
        full, long = sv["decode_32k"], sv["prefill_32k"]
        assert full["graph_equals_eager"] and full["finite"]
        assert full["stored_cache_bytes"] == full["spec_cache_bytes"] \
            < full["whole_cache_bytes"]
        assert long["stored_cache_bytes"] == long["spec_cache_bytes"]


def test_phase_handler_mode_on_the_mesh(phase):
    """``mesh.handler``: phi3.5-moe on the ("data", "model") = (1, N)
    mesh and, on more than one rank, rwkv6 on the engine's mesh, each
    graphed and bare under swaps and without, the graphed calls'
    decisions agreed on every rank (``_mesh_across``), without swaps each
    handler thread's graphed decode step captured once and replayed, and
    the B = 4 decode step timed on the mesh and off it."""
    world, recs, out = phase
    shapes = CS._mesh_shapes(world)
    assert [h["mesh"] for h in out["handler"]] == [
        dict(zip(shapes[key][1], shapes[key][0]))
        for arch, _, key in CS.MESH_HANDLER
        if world > 1 or arch in CS.MESH_HANDLER_ONE]
    for h in out["handler"]:
        assert [(r["arm"], r["swaps"]) for r in h["runs"]] == list(
            CS.MESH_HANDLER_ARMS)
        for r in h["runs"]:
            assert (r["weight_swaps"] >= 1) == r["swaps"]
            assert len(r["swap_turns"]) == (
                r["weight_swaps"] if world > 1 else 0)
            if r["arm"] == "graph":
                assert r["graphs"]["decode"]["warmups"] >= 1
            if r["arm"] == "graph" and not r["swaps"]:
                assert r["graphs"]["decode"]["captures"] == 2
                assert r["graphs"]["decode"]["replays"] >= 1
        step = h["decode_step"]
        assert step["mesh"]["steps"] == step["one"]["steps"] > 0
    for r in recs:
        assert [h["config"] for h in r["handler"]] == [
            h["config"] for h in out["handler"]]


def test_phase_controller_on_the_mesh(phase):
    """``mesh.controller``: the closed-loop replay on the engine's mesh
    made at least one decision, rank 0's, logged alike on every rank;
    neither replay dropped a request."""
    world, recs, out = phase
    ctrl = out["controller"]
    assert ctrl["mesh"] == out["engine"]["mesh"]
    assert ctrl["decisions"] >= 1 and ctrl["clock"] == "rank 0"
    assert [x["label"] for x in ctrl["replays"]] == ["static",
                                                     "closed_loop"]
    assert all(x["dropped"] == 0 for x in ctrl["replays"])
    assert ctrl["replays"][0]["decisions"] == []
    for r in recs:
        assert r["controller"]["replays"][1]["decisions"] == \
            ctrl["replays"][1]["decisions"]
