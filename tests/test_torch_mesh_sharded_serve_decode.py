"""The sharded decode step (``make_decode_step(..., sharded=True)``, the
dry run's ``"decode"`` layout from ``serve_specs``: tensor-parallel
weights, the bf16 cache's sequence over "model", a replicated scalar
``cache_len``) on gloo worlds, against ``repro``'s decode step jitted with
``launch/dryrun.py``'s shardings on fake XLA devices at the same mesh
shapes: llama3.2-1b at (data, model) = (2, 1), (1, 2), (2, 2), ("pod",
"data", "model") = (2, 2, 2), at B = 1 and with per-request lengths;
granite-20b (MQA) and phi-3-vision-4.2b (K/V heads over "model") at (2,
2).  Four steps each, two with no valid position in the upper slices of
the sequence.  Per case, on every rank and step: the tokens and logits
rows; the cache blocks against device ``r``'s ``addressable_shards`` of
``repro``'s; the entries the step wrote (the new position, on its owner
only); finite logits; the shapes the rank stores; replicated outputs
bit-equal across ranks; the graphed step (cache donated) in place and
equal to the eager one.  And the partial softmax that the slices
combine.  The tolerances are ``torch_sharded_serve_cases``'."""

import math

import numpy as np
import pytest
import torch

import torch_mesh_cases as C
import torch_sharded_serve_cases as SV

CASES = SV.DECODE_CASES
IDS = [SV.case_id(c) for c in CASES]


def _inputs(case):
    return SV.decode_inputs(C.smoke_f32(case[0]), case[3], case[4])


@pytest.fixture(scope="module")
def oracle():
    return C.jax_oracle(SV.ORACLE, SV.oracle_inputs(CASES, "decode"))


@pytest.fixture(scope="module")
def ranks(oracle):
    return SV.run_cases("decode", CASES, oracle,
                        _inputs)


def _specs(case):
    from repro_torch import configs as TC
    from repro_torch.dist.sharding import ShapeMesh
    from repro_torch.serving.steps import serve_specs

    arch, shape, names, b, _ = case
    return serve_specs(C.smoke_f32(arch), TC.get(arch)[1],
                       ShapeMesh(names, shape), "decode", b, SV.CACHE)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tokens_and_logits_match_repro(case, oracle, ranks):
    """Tokens exactly (``sharded_argmax`` over the vocab shards), the
    logits rows over the whole vocab within ``REL`` of the largest, at
    every step, eager and graphed."""
    want = oracle["cases"][SV.case_id(case)]
    for rank, r in enumerate(ranks[case]):
        for arm in ("eager", "graph"):
            for i, (got, w) in enumerate(zip(r[arm], want)):
                np.testing.assert_array_equal(
                    got["token"], SV.row_block(w["token"], r, case),
                    err_msg=f"{arm} step {i} rank {rank}")
                SV.close_rel(got["logits"], SV.row_block(w["logits"], r,
                                                         case),
                             SV.REL, (arm, i, rank))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cache_blocks_within_one_rounding_of_repros_shards(case, oracle,
                                                            ranks):
    want = oracle["cases"][SV.case_id(case)]
    for rank, r in enumerate(ranks[case]):
        for i, (got, w) in enumerate(zip(r["eager"], want)):
            assert sorted(got["caches"]) == ["k", "v"]
            for name, x in got["caches"].items():
                SV.within_bf16_rounding(x, w["caches"][name][rank],
                                        (name, i, rank))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_written_position_lands_only_on_its_owner(case, ranks):
    """Each step changes exactly the entries at ``cache_len - 1`` (per
    row, per layer) in the block of the rank whose slice of the sequence
    holds it, and nothing in any other rank's block."""
    inputs = _inputs(case)
    specs = _specs(case)
    owners = 0
    for r in ranks[case]:
        for i, step in enumerate(r["eager"]):
            n = inputs["lens"][i]
            rows = SV.row_block(n, r, case) if np.ndim(n) else None
            want = SV.expected_writes(r, case, n, rows)
            assert [tuple(x) for x in step["changed"]] == want, (i, r["coords"])
            owners += bool(want)
    assert owners > 0 and specs["caches"]["k"][2] is not None


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_slices_with_no_valid_position_give_no_nan(case, ranks):
    """The first two steps leave every slice but the first empty; every
    step's logits are finite on every rank."""
    for r in ranks[case]:
        assert all(step["finite"] for step in r["eager"])
        assert all(np.isfinite(step["logits"]).all() for step in r["graph"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_each_rank_stores_only_its_blocks(case, ranks):
    """Weights by ``param_specs(decode=True)`` (no FSDP), the cache by
    ``cache_specs``: the rank's rows and slice of the sequence."""
    from repro_torch.dist.sharding import ShapeMesh, block_shape
    from repro_torch.models import model as TM

    arch, shape, names, b, _ = case
    cfg = C.smoke_f32(arch)
    mesh = ShapeMesh(names, shape)
    specs = _specs(case)
    want = {n: block_shape(tuple(x.shape), s, mesh) for (n, x), s in zip(
        SV._shapes(TM.init_params(0, cfg, device="meta")),
        [s for _, s in SV._shapes(specs["params"])])}
    cut = block_shape((cfg.n_layers, b, SV.CACHE, cfg.n_kv_heads, cfg.hd),
                      specs["caches"]["k"], mesh)
    for r in ranks[case]:
        assert r["stored"] == want
        assert r["cache_shapes"] == {"k": cut, "v": cut}
        if shape[names.index("model")] > 1:
            assert cut[2] < SV.CACHE


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replicated_outputs_are_bit_equal(case, ranks):
    """Ranks that hold the same rows return bit-equal tokens and logits;
    ranks at the same coordinates on the cache spec's axes hold
    bit-equal blocks."""
    from repro_torch.dist.sharding import spec_axes

    specs = _specs(case)
    rows = spec_axes(specs["token"])
    caxes = spec_axes(specs["caches"]["k"])
    seen, blocks = {}, {}
    for r in ranks[case]:
        key = tuple(r["coords"][a] for a in rows)
        ckey = tuple(r["coords"][a] for a in caxes)
        for i, step in enumerate(r["eager"]):
            if (key, i) in seen:
                for k in ("token", "logits"):
                    np.testing.assert_array_equal(step[k], seen[key, i][k])
            seen[key, i] = step
            if (ckey, i) in blocks:
                for n in ("k", "v"):
                    np.testing.assert_array_equal(step["caches"][n],
                                                  blocks[ckey, i][n])
            blocks[ckey, i] = step["caches"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graphed_decode_is_in_place_and_equals_eager(case, ranks):
    """Through ``jit_mesh_step`` with the cache donated: a warm-up, a
    capture that replays, then replays; every step returns the cache
    tensors it was given, bit-equal to the eager step's; the eager steps
    write in place too.  Over "model" the steps all-gather (heads,
    logits, the argmax pairs) and all-reduce (the softmax partials,
    ``wo``)."""
    for r in ranks[case]:
        assert r["graph_stats"] == (1, 1, len(SV.DECODE_LENS) - 1)
        for e, g in zip(r["eager"], r["graph"]):
            assert e["in_place"] and g["in_place"]
            for k in ("token", "logits"):
                np.testing.assert_array_equal(g[k], e[k])
            for n in ("k", "v"):
                np.testing.assert_array_equal(g["caches"][n], e["caches"][n])
        if case[1][case[2].index("model")] > 1:
            assert r["counts"].get("all_gather", 0) > 0, r["counts"]
            assert r["counts"].get("all_reduce", 0) > 0, r["counts"]


@pytest.mark.parametrize("slices", [1, 2, 4])
def test_partial_softmax_slices_combine_to_decode_attention(slices):
    """``decode_attention_partial`` over each slice of a cache, combined
    as the sharded step combines them (max of the maxes, the rescaled
    sums and outputs), equals ``decode_attention`` over the whole cache
    within ``REL`` of the largest; a slice past every row's length gives
    ``m = -inf`` and exactly zero sums and outputs."""
    from repro_torch.models.common import (decode_attention,
                                           decode_attention_partial)

    g = torch.Generator().manual_seed(7)
    B, S, KVH, H, hd = 3, 32, 2, 4, 16
    q = torch.randn(B, 1, H, hd, generator=g)
    k = torch.randn(B, S, KVH, hd, generator=g)
    v = torch.randn(B, S, KVH, hd, generator=g)
    lens = torch.tensor([1, 9, S], dtype=torch.int32)
    n = S // slices
    parts = [decode_attention_partial(q, k[:, i * n:(i + 1) * n],
                                      v[:, i * n:(i + 1) * n], lens, i * n)
             for i in range(slices)]
    top = torch.stack([m for _, m, _ in parts]).amax(0)
    o = sum(o * torch.where(m == -math.inf, 0.0, torch.exp(m - top))[..., None]
            for o, m, _ in parts)
    den = sum(l * torch.where(m == -math.inf, 0.0, torch.exp(m - top))
              for _, m, l in parts)
    got = (o / den[..., None]).reshape(B, 1, H, hd)
    SV.close_rel(got.numpy(), decode_attention(q, k, v, lens).numpy(),
                 SV.REL, slices)
    empty = decode_attention_partial(q, k[:, 16:], v[:, 16:],
                                     torch.tensor([3, 16, 2]), 16)
    assert torch.isinf(empty[1]).all() and (empty[1] < 0).all()
    assert not empty[0].any() and not empty[2].any()
