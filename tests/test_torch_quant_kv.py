"""The port's quantized page store (int8 pages, float32 scales per page and
KV head) against ``repro``'s, on the CPU with the same seeded inputs.

* ``kernels.quant``: quantize, dequantize, the layout tag and the write
  path ``requant_scatter`` are bit-exact against ``repro.kernels.quant``
  (int8 bytes and float32 scales, bitwise): both divide in float32 and
  round half to even.
* The plain K7/K8 against ``repro``'s quantized Pallas kernels in interpret
  mode and against ``repro.kernels.ref``'s oracles: 1e-5 absolute and
  relative (float32 sums in another order, as for K5/K6).
* The quantized paged model against ``repro``'s at float32 compute: logits
  within 1e-3 relative to their largest magnitude, greedy tokens equal.  A
  K/V value that differs in its last bits between the two frameworks can
  round to a neighbouring int8 step (one step is ``amax / 127`` of its
  group), so the logits agree less tightly than on the bf16 store.
* The quantized scheduler engine against ``repro``'s on the traces of
  ``tests/test_quant_kv.py``: tokens exact, the same prefix-cache and
  quantization counters, refcounts drained; the two stores agree as stated
  in :func:`test_quant_engine_matches_jax_engine`.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as JC
from repro.core import registry as JRG
from repro.dist.sharding import MeshRules
from repro.kernels import quant as JQ
from repro.kernels import ref as JR
from repro.kernels.paged_attn import _paged_attn_quant_call
from repro.kernels.paged_chunk_attn import _chunk_attn_quant_call
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import scheduler as JS
from repro_torch import configs as TC
from repro_torch.core import registry as TRG
from repro_torch.kernels import ops as TK
from repro_torch.kernels import quant as TQ
from repro_torch.models import model as TM
from repro_torch.models.transformer import with_sink
from repro_torch.serving import engine as TE
from repro_torch.serving import scheduler as TS

ATOL = RTOL = 1e-5
MODEL_REL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _sinked(a):
    """A torch copy of ``a`` (n_pages, ...) with a sink page behind it, as
    ``init_paged_caches`` lays out each layer."""
    t = torch.zeros((a.shape[0] + 1,) + a.shape[1:],
                    dtype=torch.from_numpy(np.array(a)).dtype)
    t[:-1] = _t(a)
    return t[:-1]


# ---------------------------------------------------------------------------
# quantize / dequantize / layout tag
# ---------------------------------------------------------------------------


def _pages(seed, n=12, ps=4, kvh=2, hd=16):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, ps, kvh, hd))
         * rng.uniform(1e-3, 10.0, (n, 1, kvh, 1))).astype(np.float32)
    x[0] = 0.0                                  # an all-zero page
    x[1, 0, 0, 0] = 1e-8                        # a group below the floor
    x[2, :, 1] = 3.0                            # a constant group
    return x


@pytest.mark.parametrize("seed", range(3))
def test_quantize_matches_jax_bitwise(seed):
    x = _pages(seed)
    jq, js = (np.asarray(a) for a in JQ.quantize_pages(jnp.asarray(x)))
    tq, ts = TQ.quantize_pages(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    assert ts.numpy().tobytes() == js.tobytes()
    # every group's max lands on +-127 except where it is under the floor
    amax = np.abs(tq.numpy().astype(np.int32)).max(axis=(1, 3))
    assert (amax[2:] == 127).all()
    # the all-zero page: scale 1e-6 / 127, exact zeros back
    assert (ts[0] == np.float32(1e-6) / np.float32(127)).all()
    assert not TQ.dequantize_pages(tq[:1], ts[:1]).any()
    jd = np.asarray(JQ.dequantize_pages(jnp.asarray(jq), jnp.asarray(js)))
    td = TQ.dequantize_pages(tq, ts).numpy()
    assert td.tobytes() == jd.tobytes()
    # quantize(dequantize(q, s)) gives back q and s bit for bit
    q2, s2 = TQ.quantize_pages(TQ.dequantize_pages(tq, ts))
    assert torch.equal(q2, tq) and s2.numpy().tobytes() == ts.numpy().tobytes()


def test_saturation_to_127():
    x = np.zeros((2, 4, 2, 8), np.float32)
    x[0, 1, 0, 3] = 5.0
    x[0, 2, 0, 5] = -5.0
    x[1, :, 1] = -2.0
    tq, ts = TQ.quantize_pages(_t(x))
    jq, js = (np.asarray(a) for a in JQ.quantize_pages(jnp.asarray(x)))
    np.testing.assert_array_equal(tq.numpy(), jq)
    assert tq[0, 1, 0, 3] == 127 and tq[0, 2, 0, 5] == -127
    assert (tq[1, :, 1] == -127).all()


def test_layout_tag_matches_jax():
    for geo in [(4, 2, 16), (16, 8, 64), (8, 4, 128)]:
        assert TQ.quant_layout_tag(*geo) == JQ.quant_layout_tag(*geo)
    assert TQ.QUANT_EPS == JQ.QUANT_EPS


# ---------------------------------------------------------------------------
# requant_scatter
# ---------------------------------------------------------------------------

N_PAGES, PS, KVH, HD, LANES = 32, 4, 2, 8, 5


def _store(rng):
    """A quantized store whose every page holds stale bytes and scales (a
    reallocated page must not let them leak into its new scale)."""
    kq, vq = (rng.integers(-127, 128, (N_PAGES, PS, KVH, HD)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.2, (N_PAGES, KVH)).astype(np.float32)
              for _ in range(2))
    return kq, vq, ks, vs


# (S, new_lens, cache_len AFTER the chunk, filled lanes per row): decode
# rows, chunks with padding columns, a row with nothing new, a chunk past
# the lanes, a -1 lane inside the touched window
SCATTER_CASES = {
    "decode": (1, None, [1, 4, 5, 9, 20], [1, 1, 2, 3, 5]),
    "chunk": (6, [6, 3, 0, 5, 2], [6, 9, 8, 20, 14], [2, 3, 2, 5, 4]),
    "chunk_past_lanes": (5, [5, 5, 1, 4, 3], [22, 7, 3, 4, 19],
                         [5, 2, 1, 1, 5]),
    "hole": (3, [3, 2, 3, 1, 3], [7, 10, 3, 13, 11], [2, 3, 1, 4, 3]),
}


@pytest.mark.parametrize("name", list(SCATTER_CASES))
def test_requant_scatter_matches_jax_bitwise(name):
    s, nl, clen, filled = SCATTER_CASES[name]
    rng = np.random.default_rng(len(name))
    b = len(clen)
    kq, vq, ks, vs = _store(rng)
    kn, vn = (rng.standard_normal((b, s, KVH, HD)).astype(np.float32)
              for _ in range(2))
    perm = rng.permutation(N_PAGES)
    pages = np.full((b, LANES), -1, np.int32)
    for i, f in enumerate(filled):
        pages[i, :f] = perm[i * LANES:i * LANES + f]   # rows never share
    if name == "hole":
        pages[1, 2] = -1
    clen = np.asarray(clen, np.int32)
    nl_np = None if nl is None else np.asarray(nl, np.int32)
    want = [np.asarray(a) for a in JQ.requant_scatter(
        *map(jnp.asarray, (kq, vq, ks, vs, kn, vn, pages, clen)),
        None if nl_np is None else jnp.asarray(nl_np))]
    got = TQ.requant_scatter(*(_sinked(a) for a in (kq, vq, ks, vs)),
                             _t(kn), _t(vn), _t(pages), _t(clen),
                             None if nl_np is None else _t(nl_np))
    for w, g in zip(want, got):
        assert g.numpy().tobytes() == w.tobytes()
    # pages no row names keep their bytes and scales; the sink took the
    # dropped writes
    unnamed = ~np.isin(np.arange(N_PAGES), pages)
    for a, b_ in zip(got, (kq, vq, ks, vs)):
        np.testing.assert_array_equal(a.numpy()[unnamed], b_[unnamed])


def test_requant_scatter_leaves_shared_prefix_pages_alone():
    """A row whose first two pages are a shared prefix (all positions
    below the chunk's start): those pages and their scales come back byte
    for byte, and the sink page absorbs the invalid lanes."""
    rng = np.random.default_rng(7)
    kq, vq, ks, vs = _store(rng)
    pages = np.asarray([[3, 9, 4, -1, -1]], np.int32)
    clen = np.asarray([11], np.int32)                  # 8 shared + 3 new
    kn, vn = (rng.standard_normal((1, 4, KVH, HD)).astype(np.float32)
              for _ in range(2))
    nl = np.asarray([3], np.int32)
    store = [_sinked(a) for a in (kq, vq, ks, vs)]
    TQ.requant_scatter(*store, _t(kn), _t(vn), _t(pages), _t(clen), _t(nl))
    for a, b in zip(store, (kq, vq, ks, vs)):
        np.testing.assert_array_equal(a.numpy()[[3, 9]], b[[3, 9]])
        assert not np.array_equal(a.numpy()[4], b[4])
    # slots 3.. of page 4 were stale and lie past cache_len: now zero
    assert not store[0][4, 3:].any() and not store[1][4, 3:].any()


def test_requant_scatter_needs_the_sink():
    rng = np.random.default_rng(0)
    kq, vq, ks, vs = (_t(a) for a in _store(rng))
    with pytest.raises(ValueError, match="sink"):
        TQ.requant_scatter(kq, vq, ks, vs, torch.zeros(1, 1, KVH, HD),
                           torch.zeros(1, 1, KVH, HD),
                           torch.zeros(1, LANES, dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# K7 / K8 plain versions against the quantized Pallas kernels
# ---------------------------------------------------------------------------


def _quant_case(seed, b, s, h, kvh, ps):
    """The K5/K6 traps of ``test_torch_paged_attn`` over an int8 store:
    -1 lanes inside and past cache_len, a row with cache_len 0 (new_lens 0
    for a chunk), a partial last page, a chunk that is the whole prefix;
    plus an all-zero page and a page whose group max saturates."""
    rng = np.random.default_rng(seed)
    hd, n_pages, lanes = 16, 24, 5
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    kv = [rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32) * 2
          for _ in range(2)]
    for x in kv:
        x[0] = 0.0                                   # an all-zero page
        x[1, 0, :, 0] = 40.0                         # a saturating max
    (kq, ks), (vq, vs) = (JQ.quantize_pages(jnp.asarray(x)) for x in kv)
    kq, ks, vq, vs = (np.asarray(a) for a in (kq, ks, vq, vs))
    page_idx = np.full((b, lanes), -1, np.int32)
    cache_len = np.zeros((b,), np.int32)
    new_lens = np.zeros((b,), np.int32)
    order = rng.permutation(np.arange(2, n_pages))
    for i in range(b - 1):                           # the last row is empty
        nl = int(rng.integers(1, s + 1))
        clen = int(rng.integers(nl, lanes * ps + 1))
        if i == 0:
            clen = nl
        if i == 1:
            clen = min(lanes * ps, (clen // ps) * ps + ps // 2)
        npg = -(-clen // ps)
        page_idx[i, :npg] = order[i * lanes:i * lanes + npg]
        if i == 2 and npg > 1:
            page_idx[i, 0] = -1
        cache_len[i], new_lens[i] = clen, nl
    page_idx[1, 0], page_idx[3, 0] = 0, 1           # both trap pages read
    return q, kq, vq, ks, vs, page_idx, cache_len, new_lens


QCASES = [(seed, s, h, kvh, ps) for seed, (s, h, kvh, ps) in enumerate(
    [(1, 4, 2, 4), (5, 8, 2, 8), (8, 4, 2, 4), (3, 8, 4, 4)])]


@pytest.mark.parametrize("seed,s,h,kvh,ps", QCASES)
def test_chunk_quant_matches_pallas_and_oracle(seed, s, h, kvh, ps):
    args = _quant_case(seed, 5, s, h, kvh, ps)
    want = np.asarray(_chunk_attn_quant_call(*map(jnp.asarray, args),
                                             interpret=True))
    oracle = np.asarray(JR.paged_chunk_attn_quant_ref(*map(jnp.asarray,
                                                           args)))
    got = TK.paged_chunk_attention_quant(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    q, *_, cl, nl = args
    col = np.arange(s)
    pad = (col[None, :] < s - nl[:, None]) | (cl[:, None] - s + col < 0)
    assert pad[-1].all() and not got[pad].any() and not want[pad].any()


@pytest.mark.parametrize("seed,h,kvh,ps",
                         [(c[0], c[2], c[3], c[4]) for c in QCASES])
def test_decode_quant_matches_pallas_and_oracle(seed, h, kvh, ps):
    q, kq, vq, ks, vs, pi, cl, _ = _quant_case(seed, 5, 1, h, kvh, ps)
    cl[1] = pi.shape[1] * ps + 3           # a length past the lanes
    args = (q[:, 0], kq, vq, ks, vs, pi, cl)
    want = np.asarray(_paged_attn_quant_call(*map(jnp.asarray, args),
                                             interpret=True))
    oracle = np.asarray(JR.paged_attn_quant_ref(*map(jnp.asarray, args)))
    got = TK.paged_attention_quant(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    assert cl[-1] == 0 and not got[-1].any() and not want[-1].any()


def test_quant_operands_are_checked():
    q, kq, vq, ks, vs, pi, cl, nl = map(_t, _quant_case(0, 5, 2, 4, 2, 4))
    out = TK.paged_chunk_attention_quant(q.to(torch.bfloat16), kq, vq, ks,
                                         vs, pi, cl, nl)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="scales"):        # int8, no scales
        TK.paged_attention(q[:, 0].contiguous(), kq, vq, pi, cl)
    with pytest.raises(ValueError, match="int8"):          # scales, bf16
        TK.paged_attention_quant(q[:, 0].contiguous(), kq.float(),
                                 vq.float(), ks, vs, pi, cl)
    with pytest.raises(ValueError, match="k_scale"):
        TK.paged_attention_quant(q[:, 0].contiguous(), kq, vq, ks[:, :1],
                                 vs, pi, cl)
    with pytest.raises(ValueError, match="v_scale"):
        TK.paged_attention_quant(q[:, 0].contiguous(), kq, vq, ks,
                                 vs.double(), pi, cl)
    with pytest.raises(ValueError, match="device"):
        TK.paged_attention_quant(q[:, 0].contiguous(), kq, vq,
                                 ks.to("meta"), vs, pi, cl)


# ---------------------------------------------------------------------------
# the quantized paged model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    cj = dataclasses.replace(JC.get_smoke("llama3.2-1b"),
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke("llama3.2-1b"),
                             compute_dtype=torch.float32)
    jp = JM.init_params(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def test_quant_store_layout(models):
    _, ct, _, _ = models
    store = TM.init_paged_caches(ct, 8, 4, quantized=True, device="cpu")
    assert set(store) == {"k", "v", "k_scale", "v_scale"}
    assert store["k"].dtype == torch.int8
    assert tuple(store["k_scale"].shape) == (ct.n_layers, 8, ct.n_kv_heads)
    assert with_sink(store["v_scale"][1]).shape[0] == 9


def test_quant_paged_model_matches_jax(models):
    """Two right-aligned prompt chunks (padding columns, a shorter row)
    then decode steps, over quantized stores that start with stale bytes:
    logits within MODEL_REL of their largest magnitude, greedy equal."""
    cj, ct, jp, tp = models
    ps, lanes, n_pages, b = 4, 6, 20, 2
    rng = np.random.default_rng(5)
    perm = rng.permutation(n_pages)
    pages = np.full((b, lanes), -1, np.int32)
    pages[0, :5] = perm[:5]
    pages[1, :4] = perm[5:9]
    prompt = rng.integers(0, cj.vocab, (b, 11)).astype(np.int32)
    lens = np.asarray([11, 6], np.int32)
    jstore = JM.init_paged_caches(cj, n_pages, ps, quantized=True)
    shape = jstore["k"].shape
    stale = {k: jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
             for k in ("k", "v")}
    stale.update({k: jnp.asarray(rng.uniform(0.01, 0.1, shape[:2]
                                             + (shape[3],)), jnp.float32)
                  for k in ("k_scale", "v_scale")})
    jstore = stale
    tstore = TM.init_paged_caches(ct, n_pages, ps, quantized=True,
                                  device="cpu")
    for k in tstore:
        tstore[k].copy_(_t(jstore[k]))
    tpages = _t(pages)
    errs = []

    def both(tokens, clen, nl):
        nonlocal jstore
        jl, _, jstore = JM.forward(
            jp, cj, {"tokens": jnp.asarray(tokens)}, mesh=_mesh(),
            rules=MeshRules(), caches=jstore, cache_len=jnp.asarray(clen),
            pages=jnp.asarray(pages),
            new_lens=None if nl is None else jnp.asarray(nl))
        tl, _, _ = TM.forward(
            tp, ct, {"tokens": _t(tokens)}, caches=tstore,
            cache_len=_t(clen), pages=tpages,
            new_lens=None if nl is None else _t(nl))
        jl = np.asarray(jl)
        errs.append(float(np.abs(tl.numpy() - jl).max() / np.abs(jl).max()))
        assert errs[-1] <= MODEL_REL, errs
        np.testing.assert_allclose(tstore["k_scale"].numpy(),
                                   np.asarray(jstore["k_scale"]), rtol=1e-5)
        return tl.numpy(), jl

    width, done = 8, np.zeros(b, np.int32)
    for _ in range(2):
        chunk = np.minimum(lens - done, width)
        toks = np.zeros((b, width), np.int32)
        for i in range(b):
            toks[i, width - chunk[i]:] = prompt[i, done[i]:done[i] + chunk[i]]
        done = done + chunk
        tl, jl = both(toks, done.copy(), chunk.astype(np.int32))
    cur = jl[:, -1].argmax(-1).astype(np.int32)
    assert (tl[:, -1].argmax(-1) == cur).all()
    clen = lens.copy()
    for _ in range(4):
        clen = clen + 1
        tl, jl = both(cur[:, None], clen.copy(), None)
        nxt = jl[:, -1].argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1), nxt)
        cur = nxt


# ---------------------------------------------------------------------------
# the quantized scheduler engine
# ---------------------------------------------------------------------------

SC = dict(max_slots=2, page_size=4, max_seq=32, prefill_chunk=4,
          prefill_rows=2, token_budget=8)
BASE = np.arange(1, 15, dtype=np.int32)
DIV = BASE.copy()
DIV[6] = 99


def _serve(eng, mod, prompts, max_new, warm=0):
    reqs = [mod.Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.start()
    for r in reqs[:warm]:
        eng.submit(r)
        assert r.done.wait(timeout=600), "request timed out"
    for r in reqs[warm:]:
        eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=600), "request timed out"
    eng.stop()
    return [list(map(int, r.out)) for r in reqs]


def _engines(models, monkeypatch, n_pages=64):
    cj, ct, jp, tp = models
    monkeypatch.setattr(JRG, "next_lock_id", itertools.count(900).__next__)
    monkeypatch.setattr(TRG, "next_lock_id", itertools.count(900).__next__)
    jeng = JE.ServingEngine(cj, jp, mesh=_mesh(), rules=MeshRules(),
                            n_pages=n_pages, quant_kv=True,
                            scheduler=JS.SchedulerConfig(**SC))
    teng = TE.ServingEngine(ct, tp, n_pages=n_pages, quant_kv=True,
                            scheduler=TS.SchedulerConfig(**SC), device="cpu")
    return jeng, teng


def test_quant_engine_matches_jax_engine(models, monkeypatch):
    """The trace of ``tests/test_quant_kv.py``'s COW scenario: a warm
    request riding shared int8 pages, then the same prompt again and a
    prompt that diverges inside a page (a COW head).  Tokens exact, the
    same prefix-cache and quantization counters, refcounts drained.

    The stores after the run: scales within 1e-6 relative, int8 bytes
    within one step on at most 0.1% of the bytes (each side quantizes its
    own float32 K/V, which differ in the last bits between the
    frameworks); on this trace they read exact, which is asserted too."""
    jeng, teng = _engines(models, monkeypatch)
    prompts = [BASE, BASE, DIV]
    want = _serve(jeng, JE, prompts, 4, warm=1)
    got = _serve(teng, TE, prompts, 4, warm=1)
    assert got == want
    ts, js = teng.lock_stats()["engine"], jeng.lock_stats()["engine"]
    for k in ("pages_saved", "cow_copies", "cached_tokens",
              "pages_charged"):
        assert ts[k] == js[k], k
    assert ts["pages_saved"] >= 3 and ts["cow_copies"] >= 1
    for name in ("pool.quant_hits", "pool.quant_tokens"):
        assert teng.metrics.counter(name).value \
            == jeng.metrics.counter(name).value > 0, name
    assert teng.metrics.counter("pool.quant_hits").value >= 12
    for eng in (jeng, teng):
        pool = eng.kv_pool
        assert pool.free_count() == 64
        st = pool.stats()
        assert st["refcount_total"] == 0 and st["shared_pages"] == 0
        held = eng.registry.held_multi([eng.store.leases] + pool.locks)
        assert not np.asarray(held).any()
    for k in ("k_scale", "v_scale"):
        np.testing.assert_allclose(teng._pages_kv[k].numpy(),
                                   np.asarray(jeng._pages_kv[k]), rtol=1e-6,
                                   atol=0)
    for k in ("k", "v"):
        a = teng._pages_kv[k].numpy().astype(np.int32)
        b = np.asarray(jeng._pages_kv[k]).astype(np.int32)
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.testing.assert_array_equal(a, b)


def test_quant_engine_store_and_gauge(models):
    """``pool.hbm_bytes``: the int8 k/v leaves are exactly half the bf16
    store's and the gauge adds the scales; the prefix keys carry the
    layout tag; ``quant_kv=True`` changes nothing in handler mode."""
    _, ct, _, tp = models
    kw = dict(n_pages=64, scheduler=TS.SchedulerConfig(**SC), device="cpu")
    e_q = TE.ServingEngine(ct, tp, quant_kv=True, **kw)
    e_f = TE.ServingEngine(ct, tp, **kw)
    assert set(e_q._pages_kv) == {"k", "v", "k_scale", "v_scale"}
    assert e_q._pages_kv["k"].dtype == torch.int8

    def nbytes(eng, names):
        return sum(eng._pages_kv[n].numel() * eng._pages_kv[n].element_size()
                   for n in names)

    assert nbytes(e_f, "kv") == 2 * nbytes(e_q, "kv")
    hq = e_q.metrics.gauge("pool.hbm_bytes").value
    assert hq == nbytes(e_q, e_q._pages_kv) < e_f.metrics.gauge(
        "pool.hbm_bytes").value
    assert e_q._quant_tag == TQ.quant_layout_tag(4, ct.n_kv_heads, ct.hd)
    assert e_f._quant_tag == 0
    handler = TE.ServingEngine(ct, tp, quant_kv=True, device="cpu")
    assert handler.scheduler is None


def test_cow_copy_moves_the_scale(models):
    """The ``cow-skips-scale`` mutation of ``repro``'s checker: a COW copy
    that moved the bytes but not the scale would rescale the shared
    prefix.  After ``_copy_page`` the destination's data and scales equal
    the source's in every layer."""
    _, ct, _, tp = models
    eng = TE.ServingEngine(ct, tp, n_pages=16, quant_kv=True, device="cpu",
                           scheduler=TS.SchedulerConfig(**SC))
    gen = torch.Generator().manual_seed(0)
    for x in eng._pages_kv.values():
        if x.dtype == torch.int8:
            x.copy_(torch.randint(-127, 128, x.shape, generator=gen,
                                  dtype=torch.int8))
        else:
            x.copy_(torch.rand(x.shape, generator=gen) + 0.01)
    eng._copy_page(3, 11)
    for name, x in eng._pages_kv.items():
        assert torch.equal(x[:, 11], x[:, 3]), name
    assert not torch.equal(eng._pages_kv["k_scale"][:, 11],
                           eng._pages_kv["k_scale"][:, 4])
