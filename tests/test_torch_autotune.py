"""The port's autotune sweep (``repro_torch.kernels.autotune``) and the
tuning table its paged kernels' plans read (``ops.tuned``): the cases equal
``repro.kernels.autotune``'s, the plain versions on them agree with
``repro``'s oracles, a wrong candidate cannot win, the table merges per
card, and a knob reaches the plan only where it is a candidate."""

import json
import types

import numpy as np
import pytest
import torch

from repro.kernels import autotune as RAT
from repro.kernels import quant as RQ
from repro.kernels import ref as RR
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attn as PA
from repro_torch.kernels import paged_chunk_attn as PCA
from repro_torch.kernels import quant as Q
from repro_torch.kernels import ref as R

TOL = 1e-5


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_cases_equal_reference(seed):
    for got, want in zip(AT._decode_case(seed), RAT._decode_case(seed)):
        assert got.dtype == getattr(torch, str(_np(want).dtype))
        np.testing.assert_array_equal(got.numpy(), _np(want))
    for got, want in zip(AT._chunk_case(seed, s=16),
                         RAT._chunk_case(seed, s=16)):
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_card_shapes_keep_the_reference_draws():
    """``min_used`` only moves the least lanes a row uses: at 1 the draws
    are ``repro``'s, and the card's decode rows hold 3569-4096 positions."""
    q, k, v, pi, cl = AT._decode_case(3, **AT.CARD_SHAPES["decode"])
    assert q.shape == (16, 32, 64) and k.shape == (4096, 16, 8, 64)
    assert int(cl.min()) >= 223 * 16 + 1 and int(cl.max()) <= 4096
    assert ((pi >= 0).sum(1) >= 224).all()
    c = AT._chunk_case(3, **AT.CARD_SHAPES["chunk"])
    assert c[0].shape == (2, 32, 32, 64) and (c[5] == 32).all()


@pytest.mark.parametrize("seed", [0, 5])
def test_plain_versions_equal_reference_oracles(seed):
    q, k, v, pi, cl = AT._decode_case(seed)
    jq, jk, jv, jpi, jcl = RAT._decode_case(seed)
    got = R.paged_attn_ref(q, k, v, pi, cl)
    want = RR.paged_attn_ref(jq, jk, jv, jpi, jcl)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=0)
    kq, ks = Q.quantize_pages(k)
    vq, vs = Q.quantize_pages(v)
    jkq, jks = RQ.quantize_pages(jk)
    jvq, jvs = RQ.quantize_pages(jv)
    np.testing.assert_array_equal(kq.numpy(), _np(jkq))
    got = R.paged_attn_quant_ref(q, kq, vq, ks, vs, pi, cl)
    want = RR.paged_attn_quant_ref(jq, jkq, jvq, jks, jvs, jpi, jcl)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=0)
    cq, ck, cv, cpi, ccl, cnl = AT._chunk_case(seed)
    jcq, _, _, _, _, jcnl = RAT._chunk_case(seed)
    got = R.paged_chunk_attn_ref(cq, ck, cv, cpi, ccl, cnl)
    want = RR.paged_chunk_attn_ref(jcq, jk, jv, jpi, jcl, jcnl)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=0)
    got = R.paged_chunk_attn_quant_ref(cq, kq, vq, ks, vs, cpi, ccl, cnl)
    want = RR.paged_chunk_attn_quant_ref(jcq, jkq, jvq, jks, jvs, jpi, jcl,
                                         jcnl)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL, rtol=0)


def test_cpu_sweep_checks_every_candidate_and_times_nothing():
    report = AT.sweep(device="cpu")
    assert set(report) == set(AT.KNOBS) == set(RAT._candidates(0, 16))
    for kernel, r in report.items():
        knob, cands = AT.KNOBS[kernel]
        assert r["knob"] == knob and r["mode"] == "plain"
        assert list(r["results"]) == list(cands) and 0 in cands
        for rec in r["results"].values():
            assert rec["ms"] is None and rec["readings_ms"] == []
            assert rec["max_abs_err"] <= TOL
        assert r["best"] == 0


def test_wrong_candidate_is_marked_and_cannot_win(monkeypatch):
    real = AT._candidates

    def planted(*a, **kw):
        specs = real(*a, **kw)
        for kernel, bad in (("paged_attn", 128), ("paged_chunk_attn", 16)):
            fn = specs[kernel]["fn"]
            specs[kernel]["fn"] = (lambda c, fn=fn, bad=bad:
                                   fn(c) + (1e-3 if c == bad else 0.0))
        return specs

    monkeypatch.setattr(AT, "_candidates", planted)
    report = AT.sweep(device="cpu")
    assert report["paged_attn"]["results"][128] == "WRONG"
    assert report["paged_chunk_attn"]["results"][16] == "WRONG"
    assert report["paged_attn"]["best"] != 128
    assert report["paged_chunk_attn"]["best"] != 16
    assert report["paged_attn_quant"]["results"][128] != "WRONG"


def _rec(ms, plan):
    return {"ms": None, "readings_ms": [ms, ms], "plan": plan,
            "max_abs_err": 0.0}


def test_best_is_the_fastest_distinct_plan():
    res = {0: _rec(2.0, [4, 64]), 128: _rec(1.0, [4, 64]),
           512: _rec(1.5, [2, 128]), 1024: "WRONG"}
    # 128 is fastest but launches 0's plan; 1024 is wrong
    assert AT._best(res, [0, 128, 512]) == 512
    res[512] = _rec(2.5, [2, 128])
    assert AT._best(res, [0, 128, 512]) == 0
    assert res[0]["ms"] == 2.0
    assert AT._best({0: "WRONG", 16: _rec(1.0, [16, 1, 256])}, [16]) == 16
    assert AT._best({0: "WRONG"}, []) is None


def test_run_merges_and_keeps_other_cards(tmp_path, monkeypatch):
    path = tmp_path / "table.json"
    path.write_text(json.dumps({
        "paged_attn": {"Other Card": {"min_split_positions": 512}},
        "paged_chunk_attn": {"Test Card": {"pairs": 128}}}))
    fake = {k: {"knob": knob, "mode": "cuda", "results": {},
                "best": {"paged_attn": 1024, "paged_chunk_attn": 16,
                         "paged_attn_quant": None,
                         "paged_chunk_attn_quant": 0}[k]}
            for k, (knob, _) in AT.KNOBS.items()}
    monkeypatch.setattr(AT, "sweep", lambda **kw: fake)
    AT.run(str(path), device="cpu", card="Test Card")
    table = json.loads(path.read_text())
    assert table == {
        "paged_attn": {"Other Card": {"min_split_positions": 512},
                       "Test Card": {"min_split_positions": 1024}},
        "paged_chunk_attn": {"Test Card": {"pairs": 16}},
        "paged_chunk_attn_quant": {"Test Card": {"pairs": 0}}}
    # the CPU names no card: nothing written without one
    path2 = tmp_path / "none.json"
    AT.run(str(path2), device="cpu")
    assert not path2.exists()


def test_decode_splits_honour_the_knob():
    shape = (16, 32, 8, 256, 16, 132, 8)     # 16 rows of 4096 positions
    assert PA.decode_splits(*shape) == (8, 32)           # 256 a split
    assert PA.decode_splits(*shape, 1024) == (4, 64)
    assert PA.decode_splits(*shape, 512) == (8, 32)
    for off in (0, 256, 1000, -1):           # 0 or outside the candidates
        assert PA.decode_splits(*shape, off) == PA.decode_splits(*shape)
    # rows of 2048 positions: 128 lets a fuller wave split them
    assert PA.decode_splits(16, 32, 8, 128, 16, 132, 16) == (8, 16)
    assert PA.decode_splits(16, 32, 8, 128, 16, 132, 16, 128) == (16, 8)


def test_chunk_pairs_honour_the_knob():
    long = (2, 32, 32, 8, 64, 256, 16, 132)
    tick = (2, 32, 32, 8, 64, 8, 16, 132)
    wide_hd = (2, 32, 32, 8, 128, 256, 16, 132)
    assert PCA.chunk_pairs(*long) == 128 and PCA.chunk_pairs(*tick) == 16
    assert PCA.chunk_pairs(*long, 16) == 16
    assert PCA.chunk_pairs(*tick, 128) == 128
    for off in (0, 64, 32, 7):    # 64 is not built at hd 64
        assert PCA.chunk_pairs(*long, off) == 128
        assert PCA.chunk_pairs(*tick, off) == 16
    for knob in PCA.PAIRS_CANDIDATES:        # only 64 is built at hd 128
        assert PCA.chunk_pairs(*wide_hd, knob) == 64


@pytest.fixture
def table(tmp_path, monkeypatch):
    """A tuning table for a stand-in card named "Test Card"; the plans'
    card queries answered on the host."""
    path = tmp_path / "tuning_table.json"
    monkeypatch.setattr(ops, "TUNING_PATH", path)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "Test Card")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(PA, "decode_residency", lambda *a, **kw: 8)
    monkeypatch.setattr(PCA, "chunk_residency", lambda *a, **kw: (2, 0))

    def write(entries):
        path.write_text(json.dumps(entries))
        ops._tuning.cache_clear()
        ops.tuned.cache_clear()
    yield write
    ops._tuning.cache_clear()
    ops.tuned.cache_clear()


def _plans():
    q = torch.zeros(16, 32, 64)
    k = torch.zeros(8, 16, 8, 64, dtype=torch.bfloat16)
    kq = torch.zeros(8, 16, 8, 64, dtype=torch.int8)
    cq = torch.zeros(2, 32, 32, 64)
    return (PA.decode_plan(q, k, 256), PA.decode_plan(q, kq, 256),
            PCA.chunk_plan(cq, k, 256), PCA.chunk_plan(cq, kq, 256))


def test_plans_read_the_table_for_this_card(table):
    table({})
    base = _plans()
    assert base == ((8, 32), (8, 32), (128, 8, 32), (128, 8, 32))
    table({"paged_attn": {"Test Card": {"min_split_positions": 1024}},
           "paged_chunk_attn_quant": {"Test Card": {"pairs": 16}}})
    got = _plans()
    assert got[0] == (4, 64) and got[1] == base[1]
    assert got[2] == base[2] and got[3][0] == 16
    assert ops.tuned("paged_attn", "min_split_positions", 0) == 1024


@pytest.mark.parametrize("entries", [
    None,                                                     # no file
    {},                                                       # no kernel
    {"paged_attn": {"Other Card": {"min_split_positions": 1024}}},
    {"paged_attn": {"Test Card": {"lanes_per_step": 2}}},     # no knob
    {"paged_attn": {"Test Card": {"min_split_positions": 0}}},
    {"paged_attn": {"Test Card": {"min_split_positions": 300}}},
    {"paged_attn": {"Test Card": {"min_split_positions": "1024"}}},
    {"paged_chunk_attn": {"Test Card": {"pairs": 64}}},
    {"paged_chunk_attn": {"Test Card": {"pairs": 48}}},
])
def test_plans_fall_back_without_a_usable_entry(table, entries):
    table({})
    base = _plans()
    if entries is None:
        ops.TUNING_PATH.unlink()
        ops._tuning.cache_clear()
        ops.tuned.cache_clear()
    else:
        table(entries)
    assert _plans() == base


def test_committed_table_names_only_candidates():
    table = json.loads(ops.TUNING_PATH.read_text())
    for kernel, cards in table.items():
        knob, cands = AT.KNOBS[kernel]
        for card, entry in cards.items():
            assert set(entry) == {knob} and entry[knob] in cands, (kernel,
                                                                   card)


def test_cli_raises_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AT.main([])
    assert AT.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "mode=plain" in out and "WRONG" not in out
