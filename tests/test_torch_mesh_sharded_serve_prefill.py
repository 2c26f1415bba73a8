"""The sharded prefill step (``make_prefill_step(..., sharded=True)``, the
dry run's ``"prefill"`` layout from ``serve_specs``) on gloo worlds, against
``repro``'s prefill step jitted with ``launch/dryrun.py``'s shardings on
fake XLA devices at the same mesh shapes: llama3.2-1b at (data, model) =
(2, 1), (1, 2), (2, 2), ("pod", "data", "model") = (2, 2, 2) and at B = 1;
granite-20b (MQA), phi-3-vision-4.2b (K/V heads over "model", patch
embeddings) and hubert-xlarge (the encoder, no cache) at (2, 2).  Per
case, on every rank: the last position's logits rows; the cache blocks
against device ``r``'s ``addressable_shards`` of ``repro``'s caches in
``cache_specs``' layout; the shapes the rank stores (only its blocks);
replicated outputs bit-equal across ranks; the graphed step equal to the
eager one.  And the layouts ``serve_specs`` and ``forward`` refuse.  The
tolerances are ``torch_sharded_serve_cases``'."""

import numpy as np
import pytest

import torch_mesh_cases as C
import torch_sharded_serve_cases as SV

CASES = SV.PREFILL_CASES
IDS = [SV.case_id(c) for c in CASES]


@pytest.fixture(scope="module")
def oracle():
    return C.jax_oracle(SV.ORACLE, SV.oracle_inputs(CASES, "prefill"))


@pytest.fixture(scope="module")
def ranks(oracle):
    return SV.run_cases("prefill", CASES, oracle,
                        lambda c: SV.prefill_batch(C.smoke_f32(c[0]), c[3]))


def _specs(case):
    from repro_torch import configs as TC
    from repro_torch.dist.sharding import ShapeMesh
    from repro_torch.serving.steps import serve_specs

    arch, shape, names, b, _ = case
    return serve_specs(C.smoke_f32(arch), TC.get(arch)[1],
                       ShapeMesh(names, shape), "prefill", b, SV.PROMPT)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_last_logits_match_repro(case, oracle, ranks):
    want = oracle["cases"][SV.case_id(case)]["logits"]
    for rank, r in enumerate(ranks[case]):
        assert np.isfinite(r["logits"]).all()
        SV.close_rel(r["logits"], SV.row_block(want, r, case), SV.REL,
                     ("logits", rank))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cache_blocks_match_repros_shards(case, oracle, ranks):
    """Each rank's K/V blocks (its rows, its slice of the sequence, every
    K/V head) against device ``r``'s shard of ``repro``'s caches; the
    encoder makes none."""
    want = oracle["cases"][SV.case_id(case)].get("caches")
    for rank, r in enumerate(ranks[case]):
        if want is None:
            assert "caches" not in r
            continue
        assert sorted(r["caches"]) == sorted(want) == ["k", "v"]
        for name, by_dev in want.items():
            SV.close_rel(r["caches"][name], by_dev[rank], SV.REL,
                         (name, rank))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_each_rank_stores_only_its_blocks(case, ranks):
    """The parameter blocks are ``param_specs``' (FSDP and tensor
    parallel) and the cache blocks ``cache_specs``'; with the sequence
    over "model" no rank holds a whole cache."""
    from repro_torch.dist.sharding import ShapeMesh, block_shape
    from repro_torch.models import model as TM

    arch, shape, names, b, _ = case
    cfg = C.smoke_f32(arch)
    mesh = ShapeMesh(names, shape)
    specs = _specs(case)
    want = {n: block_shape(tuple(x.shape), s, mesh) for (n, x), s in zip(
        SV._shapes(TM.init_params(0, cfg, device="meta")),
        [s for _, s in SV._shapes(specs["params"])])}
    whole = (cfg.n_layers, b, SV.PROMPT, cfg.n_kv_heads, cfg.hd)
    for r in ranks[case]:
        assert r["stored"] == want
        if specs["caches"] is None:
            continue
        cut = block_shape(whole, specs["caches"]["k"], mesh)
        assert r["cache_shapes"] == {"k": cut, "v": cut}
        if shape[names.index("model")] > 1:
            assert cut[2] < SV.PROMPT


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replicated_outputs_are_bit_equal(case, ranks):
    """Ranks that hold the same rows hold bit-equal logits, and ranks at
    the same coordinates on the axes a cache spec names bit-equal cache
    blocks."""
    from repro_torch.dist.sharding import spec_axes

    specs = _specs(case)
    rows = spec_axes(specs["batch"][next(iter(specs["batch"]))])
    seen, blocks = {}, {}
    for r in ranks[case]:
        key = tuple(r["coords"][a] for a in rows)
        if key in seen:
            np.testing.assert_array_equal(r["logits"], seen[key])
        seen[key] = r["logits"]
        if specs["caches"] is None:
            continue
        ckey = tuple(r["coords"][a] for a in spec_axes(specs["caches"]["k"]))
        if ckey in blocks:
            for n in ("k", "v"):
                np.testing.assert_array_equal(r["caches"][n], blocks[ckey][n])
        blocks[ckey] = r["caches"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graphed_prefill_equals_eager(case, ranks):
    """Through ``jit_mesh_step`` on the stand-in graph: a warm-up, a
    capture that replays, a replay, each bit-equal to the eager step; the
    FSDP all-gathers (and over "model", the psums) issued."""
    for r in ranks[case]:
        assert r["jit"]["stats"] == (1, 1, 2)
        for logits, caches in zip(r["jit"]["logits"], r["jit"]["caches"]):
            np.testing.assert_array_equal(logits, r["logits"])
            if caches is not None:
                for n, x in caches.items():
                    np.testing.assert_array_equal(x, r["caches"][n])
        assert r["counts"].get("all_gather", 0) > 0, r["counts"]
        if case[1][case[2].index("model")] > 1:
            assert r["counts"].get("all_reduce", 0) > 0, r["counts"]


# the layouts the sharded steps do not execute yet (ROADMAP Queue 1), each
# with the words its NotImplementedError names
REFUSED = {"gemma-2b": ("seqshard attention",),
           "minicpm-2b": ("residual_seq",),
           "phi3.5-moe-42b-a6.6b": ("the moe stack's dense leaves",),
           "rwkv6-7b": ("the ssm stack's dense leaves",),
           "zamba2-2.7b": ("the hybrid stack's dense leaves",)}


@pytest.mark.parametrize("arch", sorted(REFUSED))
def test_unsupported_layouts_refuse(arch):
    """``serve_specs`` (so both sharded steps) and a ``forward`` under
    specs raise before anything runs, naming each missing layout."""
    import torch

    from repro_torch import configs as TC
    from repro_torch.dist.sharding import ShapeMesh, param_specs
    from repro_torch.models import model as TM
    from repro_torch.serving import steps as ST

    cfg, rules, _ = TC.get(arch)
    mesh = ShapeMesh(("data", "model"), (2, 2))
    for kind in ("prefill", "decode"):
        with pytest.raises(NotImplementedError) as e:
            ST.serve_specs(cfg, rules, mesh, kind, 4, 64)
        for what in REFUSED[arch]:
            assert what in str(e.value), (what, str(e.value))
    with pytest.raises(NotImplementedError) as e:
        ST.make_decode_step(cfg, mesh, rules, sharded=True, shape=(4, 64))
    smoke = TC.get_smoke(arch)
    p = TM.init_params(0, smoke, device="cpu")
    specs = param_specs(TM.init_params(0, smoke, device="meta"), rules, mesh)
    with pytest.raises(NotImplementedError) as e:
        TM.forward(p, smoke, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                   mesh=mesh, rules=rules, specs=specs)
    for what in REFUSED[arch]:
        assert what in str(e.value), (what, str(e.value))


def test_head_split_over_too_many_model_ranks_refuses():
    """The llama smoke config's 4 query heads over "model" = 8 would split
    a head: both steps and the forward refuse, naming ``wq``."""
    import torch

    from repro_torch import configs as TC
    from repro_torch.dist.sharding import ShapeMesh, param_specs
    from repro_torch.models import model as TM
    from repro_torch.serving import steps as ST

    cfg, rules = C.smoke_f32("llama3.2-1b"), TC.get("llama3.2-1b")[1]
    mesh = ShapeMesh(("data", "model"), (1, 8))
    for kind in ("prefill", "decode"):
        with pytest.raises(NotImplementedError, match="wq split inside a head"):
            ST.serve_specs(cfg, rules, mesh, kind, 4, 64)
    specs = param_specs(TM.init_params(0, cfg, device="meta"), rules, mesh)
    with pytest.raises(NotImplementedError, match="wq split inside a head"):
        TM.forward(TM.init_params(0, cfg, device="cpu"), cfg,
                   {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                   mesh=mesh, rules=rules, specs=specs)


def test_encoder_has_no_sharded_decode():
    """hubert-xlarge keeps ``repro``'s ``ValueError`` for decode, from the
    step and from ``serve_specs``; its prefill specs make no cache."""
    from repro_torch import configs as TC
    from repro_torch.dist.sharding import ShapeMesh
    from repro_torch.serving import steps as ST

    cfg, rules, _ = TC.get("hubert-xlarge")
    mesh = ShapeMesh(("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="no decode step"):
        ST.make_decode_step(cfg, mesh, rules, sharded=True, shape=(4, 64))
    with pytest.raises(ValueError, match="no decode step"):
        ST.serve_specs(cfg, rules, mesh, "decode", 4, 64)
    specs = ST.serve_specs(cfg, rules, mesh, "prefill", 4, 64)
    assert specs["caches"] is None and list(specs["batch"]) == ["embeds"]


def test_serve_specs_equal_the_dry_runs():
    """``serve_specs`` on the production meshes' shapes equals the specs
    ``launch/dryrun.py`` builds from ``param_specs``, ``cache_specs`` and
    ``batch_spec``: FSDP on at prefill and off at decode, the cache's
    sequence over "model" (over ("data", "model") asked at B = 1, where
    ``cache_specs`` keeps "data" off the sequence as it books it for the
    batch), the tokens' rows over the batch axes, ``cache_len``
    replicated."""
    from repro_torch import configs as TC
    from repro_torch.dist.sharding import (P, ShapeMesh, batch_spec,
                                           cache_specs, param_specs)
    from repro_torch.models import model as TM
    from repro_torch.serving import steps as ST

    cfg, rules, _ = TC.get("llama3.2-1b")
    pshape = TM.init_params(0, cfg, device="meta")
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        mesh = ShapeMesh(names, shape)
        for b, seq_axes in ((128, ("model",)), (1, ("data", "model"))):
            cshape = TM.init_caches(cfg, b, 32768, device="meta")
            pre = ST.serve_specs(cfg, rules, mesh, "prefill", b, 32768)
            dec = ST.serve_specs(cfg, rules, mesh, "decode", b, 32768)
            assert pre["params"] == param_specs(pshape, rules, mesh)
            assert dec["params"] == param_specs(pshape, rules, mesh,
                                                decode=True)
            want = cache_specs(cshape, rules, mesh, seq_axes=seq_axes)
            assert pre["caches"] == dec["caches"] == want
            assert dec["token"] == pre["batch"]["tokens"] == batch_spec(
                rules, mesh, (b, 1))
            assert dec["cache_len"] == P()
            assert want["k"][2] == "model"
