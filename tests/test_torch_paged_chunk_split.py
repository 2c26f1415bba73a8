"""The chunk kernel's KV split (K6, and K8 over int8 pages) and its bf16
split of float32 products, held to JAX on the CPU.

``repro_torch.kernels.ref.paged_chunk_attn_split_ref`` writes out the CUDA
kernel's two passes: each split's online softmax state (m, l, acc) over its
run of page lanes, tile by tile, then the merge.  Here it is held against
``repro``'s Pallas chunk kernels in interpret mode and against
``repro.kernels.ref``'s oracles, at split counts 1, 2, 3 and one per lane,
over bf16, float32 and int8 pages, on cases with ``cache_len`` 0 and
``new_lens`` 0 (exact zeros), padding columns, a -1 lane inside a length,
splits wholly past ``cache_len``, a chunk longer than its paged prefix, and
48 query heads on one KV head (granite-20b's grouping).  ``chunk_splits``,
which picks the kernel's split count from host shapes alone, is pinned too,
and so is the three-way bf16 split the kernel feeds its tensor cores with.

Tolerance: 1e-5 absolute and relative.  Every side computes in float32 and
sums in its own order (the Pallas kernels page by page, the transcription
split by split and tile by tile), so outputs of O(1) differ in the last
bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as JQ
from repro.kernels import ref as JR
from repro.kernels.paged_chunk_attn import (_chunk_attn_call,
                                            _chunk_attn_quant_call)
from repro_torch.kernels import ops as TK
from repro_torch.kernels import paged_chunk_attn as PCA
from repro_torch.kernels import ref as TR

ATOL = RTOL = 1e-5
B, S, HD, PS, LANES, N_PAGES = 6, 6, 16, 4, 7, 48
TILE = 8          # the transcription's tile: several tiles a split


def _case(seed, kv, h=4, kvh=2):
    """Row 0: cache_len 0, new_lens 0.  Row 1: three real columns of six
    (padding columns) on a short prefix, so every split past the first
    lies past cache_len.  Row 2: a -1 lane inside its length.  Row 3: a
    chunk of six on a prefix of two (a chunk longer than its paged prefix).
    Rows 4-5: seeded lengths and chunk widths on distinct pages."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, h, HD)).astype(np.float32)
    kp, vp = (rng.normal(size=(N_PAGES, PS, kvh, HD)).astype(np.float32)
              for _ in range(2))
    nl = np.asarray([0, 3, 4, 6, *rng.integers(1, S + 1, 2)], np.int32)
    clen = np.asarray([0, 5, LANES * PS - 2, 8,
                       *rng.integers(S, LANES * PS + 1, 2)], np.int32)
    page_idx = np.full((B, LANES), -1, np.int32)
    perm = rng.permutation(N_PAGES)
    for i in range(B):
        npg = -(-min(int(clen[i]), LANES * PS) // PS)
        page_idx[i, :npg] = perm[i * LANES:i * LANES + npg]
    page_idx[2, 2] = -1
    if kv == "int8":
        (kq, ks), (vq, vs) = (JQ.quantize_pages(jnp.asarray(x))
                              for x in (kp, vp))
        return q, (np.asarray(kq), np.asarray(vq)), (np.asarray(ks),
                                                     np.asarray(vs)), \
            page_idx, clen, nl
    if kv == "bf16":                 # both sides read the same rounded pages
        kp, vp = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                  for x in (kp, vp))
    return q, (kp, vp), (), page_idx, clen, nl


def _t(x, kv=None):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if kv == "bf16" else t


def _jax(q, pages, scales, pi, cl, nl):
    """-> (repro's Pallas kernel in interpret mode, repro's oracle)."""
    args = [jnp.asarray(x) for x in (q, *pages, *scales, pi, cl, nl)]
    if scales:
        return (np.asarray(_chunk_attn_quant_call(*args, interpret=True)),
                np.asarray(JR.paged_chunk_attn_quant_ref(*args)))
    return (np.asarray(_chunk_attn_call(*args, interpret=True)),
            np.asarray(JR.paged_chunk_attn_ref(*args)))


def _split(q, pages, scales, pi, cl, nl, kv, n_split):
    pps = -(-LANES // n_split)
    n = -(-LANES // pps)
    return TR.paged_chunk_attn_split_ref(
        _t(q), *(_t(x, kv) for x in pages), _t(pi), _t(cl), _t(nl), n, pps,
        *(_t(x) for x in scales), tile=TILE).numpy()


def _padding(cl, nl, s=S):
    col = np.arange(s)
    return (col[None, :] < s - nl[:, None]) | (cl[:, None] - s + col < 0)


@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("n_split", [1, 2, 3, LANES])
def test_split_passes_match_jax(n_split, kv):
    q, pages, scales, pi, cl, nl = _case(n_split, kv)
    got = _split(q, pages, scales, pi, cl, nl, kv, n_split)
    kernel, oracle = _jax(q, pages, scales, pi, cl, nl)
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    pad = _padding(cl, nl)
    assert pad[0].all() and pad[1].any()
    assert not got[pad].any() and not kernel[pad].any()


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_forty_eight_heads_on_one_kv_head(kv):
    """granite-20b's grouping: 48 query heads on one KV head, so a pair
    block of 64 spans columns and one column spans pair blocks."""
    q, pages, scales, pi, cl, nl = _case(5, kv, h=48, kvh=1)
    kernel, oracle = _jax(q, pages, scales, pi, cl, nl)
    for n_split in (1, 3):
        got = _split(q, pages, scales, pi, cl, nl, kv, n_split)
        np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_rows_and_splits_with_nothing_valid(kv):
    """Only -1 lanes, or every split past cache_len: exact zeros, never a
    NaN from -inf - (-inf); every split count gives the unsplit result."""
    q, pages, scales, pi, cl, nl = _case(9, kv)
    pi[4] = -1                                   # a row of -1 lanes only
    for n_split in (2, 3, LANES):
        got = _split(q, pages, scales, pi, cl, nl, kv, n_split)
        assert np.isfinite(got).all()
        assert not got[[0, 4]].any()
        np.testing.assert_allclose(
            got, _split(q, pages, scales, pi, cl, nl, kv, 1), atol=ATOL,
            rtol=RTOL)
    kernel, _ = _jax(q, pages, scales, pi, cl, nl)
    assert not kernel[[0, 4]].any()


def test_plain_version_equals_the_split_passes():
    """The wrappers' plain versions (the CPU path) against the transcription
    at the split count the kernel would pick for this shape on a card of
    132 SMs holding 3 of its CTAs each."""
    n, pps = PCA.chunk_splits(B, S, 4, 2, LANES, PS, 132, 3)
    for kv in ("f32", "int8"):
        q, pages, scales, pi, cl, nl = _case(11, kv)
        args = [_t(x) for x in (q, *pages, *scales, pi, cl, nl)]
        plain = (TK.paged_chunk_attention_quant(*args) if scales
                 else TK.paged_chunk_attention(*args)).numpy()
        got = TR.paged_chunk_attn_split_ref(
            _t(q), *map(_t, pages), _t(pi), _t(cl), _t(nl), n, pps,
            *map(_t, scales)).numpy()
        np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)


def test_chunk_splits_depend_on_shapes_only():
    # the engine's prefill tick: 2 rows x 32 columns, 8 lanes of 16 (128
    # positions): one split, no second pass
    assert PCA.chunk_splits(2, 32, 32, 8, 8, 16, 132, 3) == (1, 8)
    # the long prefix at the engine's chunk width: 32 CTAs a split; a wave
    # of 3 CTAs an SM would take 12 splits, positions allow 8 of 512
    assert PCA.chunk_splits(2, 32, 32, 8, 256, 16, 132, 3) == (8, 32)
    assert PCA.chunk_splits(2, 32, 32, 8, 256, 16, 132, 1) == (4, 64)
    # the wide chunk: 256 CTAs a split already fill the wave
    assert PCA.chunk_splits(2, 256, 32, 8, 256, 16, 132, 3) == (1, 256)
    # the layout: at head_dim 33-64, 128 pairs a CTA, or 16 where the rows
    # are too short to split and the grid stays short of the SMs (the tick:
    # 16 CTAs of 128 pairs); 64 pairs at other head_dims
    assert PCA.chunk_pairs(2, 32, 32, 8, 64, 8, 16, 132) == 16
    assert PCA.chunk_pairs(2, 32, 32, 8, 64, 256, 16, 132) == 128
    assert PCA.chunk_pairs(8, 256, 32, 8, 64, 8, 16, 132) == 128
    assert PCA.chunk_pairs(2, 32, 32, 8, 128, 8, 16, 132) == 64
    assert PCA.chunk_pairs(2, 32, 32, 8, 16, 256, 16, 132) == 64
    assert PCA.chunk_splits(2, 32, 32, 8, 8, 16, 132, 6, 16) == (1, 8)
    assert PCA.chunk_splits(2, 32, 32, 8, 256, 16, 132, 2, 128) == (8, 32)
    # granite-20b's 48 heads on one KV head: 3 columns are 144 pairs
    assert PCA.pair_blocks(3, 48, 1) == 3
    assert PCA.chunk_splits(4, 3, 48, 1, 300, 16, 132, 2) == (9, 34)
    assert PCA.chunk_splits(2, 8, 8, 1, 0, 16, 132, 3) == (1, 0)
    rng = np.random.default_rng(0)
    for _ in range(500):
        b, kvh, resident = (int(x) for x in rng.integers(1, 33, 3))
        s = int(rng.integers(1, 513))
        h = kvh * int(rng.integers(1, 49))
        lanes, ps = int(rng.integers(1, 5000)), int(rng.integers(1, 65))
        n, pps = PCA.chunk_splits(b, s, h, kvh, lanes, ps, 132, resident)
        assert 1 <= pps <= lanes
        assert (n - 1) * pps < lanes <= n * pps     # no split is empty
        assert n == 1 or pps * ps >= PCA.MIN_CHUNK_SPLIT_POSITIONS // 2
        ctas = b * kvh * PCA.pair_blocks(s, h, kvh)
        assert n == 1 or n * ctas <= resident * 132      # one wave


@pytest.mark.parametrize("scale", [1e-20, 1e-8, 1e-3, 1.0, 7.5, 1e4, 1e20])
def test_bf16_split3_rebuilds_float32_exactly(scale):
    rng = np.random.default_rng(int(np.log10(scale) + 40))
    x = torch.from_numpy((rng.normal(size=4096) * scale).astype(np.float32))
    hi, mid, lo = TR.bf16_split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.float() + mid.float() + lo.float(), x)
    assert torch.equal((x - hi.float() - mid.float()).to(torch.bfloat16)
                       .float(), x - hi.float() - mid.float())


@pytest.mark.parametrize("b_pieces", [1, 3])
def test_split_products_match_the_float32_dot(b_pieces):
    """The kernel's products, emulated: q (float32) in three pieces against
    bf16-exact K (bf16 or int8 pages) or, for float32 pages, K in three
    pieces with the products of order <= 2; against the float32 dot
    (computed in float64 and rounded), within 1e-6 at dots of O(1) (q
    scaled by 1/sqrt(64), as the kernel's scores are)."""
    rng = np.random.default_rng(b_pieces)
    a = torch.from_numpy((rng.normal(size=(64, 64)) / 8).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32))
    if b_pieces == 1:
        b = b.to(torch.bfloat16).float()
    want = (a.double() @ b.double().T).float()
    got = TR.split3_dot(a[:, None, :], b[None, :, :], b_pieces)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    # one bf16 piece of q alone misses by far more: the split is needed
    one = (a.to(torch.bfloat16).float() @ b.T)
    assert float((one - want).abs().max()) > 1e-4
