"""The decode kernel's KV split (K5, and K7 over int8 pages) held to JAX on
the CPU.

``repro_torch.kernels.ref.paged_attn_split_ref`` writes out the CUDA
kernel's two passes: each split's softmax state (m, l, acc) over its run of
page lanes, then the merge.  Here it is held against ``repro``'s Pallas
decode kernels in interpret mode and against ``repro.kernels.ref``'s
oracles, at split counts 1, 2, 3 and one per lane, on cases with splits
entirely past ``cache_len``, splits of -1 lanes only, a row with
``cache_len`` 0 (exact zeros) and a length past the lanes, over bf16,
float32 and int8 pages.  ``decode_splits``, which picks the kernel's split
count from host shapes alone, is pinned too.

Tolerance: 1e-5 absolute and relative.  Every side computes in float32 and
sums in its own order (the Pallas kernels page by page, the transcription
split by split), so outputs of O(1) differ in the last bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro.kernels import quant as JQ
from repro.kernels import ref as JR
from repro.kernels.paged_attn import _paged_attn_quant_call
from repro_torch.kernels import ops as TK
from repro_torch.kernels import paged_attn as PA
from repro_torch.kernels import ref as TR

ATOL = RTOL = 1e-5
B, H, KVH, HD, PS, LANES, N_PAGES = 6, 4, 2, 16, 4, 6, 40


def _case(seed, kv):
    """Row 0: cache_len 0.  Row 1: 5 positions (every split past the
    first lies past cache_len).  Row 2: lanes 2-4 are -1 inside its length
    (a split of -1 lanes only at 2 and 3 splits).  Row 3: a length past the
    lanes.  Rows 4-5: seeded lengths with distinct pages."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    kp, vp = (rng.normal(size=(N_PAGES, PS, KVH, HD)).astype(np.float32)
              for _ in range(2))
    cache_len = np.asarray([0, 5, LANES * PS, LANES * PS + 3,
                            *rng.integers(1, LANES * PS + 1, 2)], np.int32)
    page_idx = np.full((B, LANES), -1, np.int32)
    perm = rng.permutation(N_PAGES)
    for i in range(B):
        npg = -(-min(int(cache_len[i]), LANES * PS) // PS)
        page_idx[i, :npg] = perm[i * LANES:i * LANES + npg]
    page_idx[2, 2:5] = -1
    if kv == "int8":
        (kq, ks), (vq, vs) = (JQ.quantize_pages(jnp.asarray(x))
                              for x in (kp, vp))
        return q, (np.asarray(kq), np.asarray(vq)), (np.asarray(ks),
                                                     np.asarray(vs)), \
            page_idx, cache_len
    if kv == "bf16":                 # both sides read the same rounded pages
        kp, vp = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                  for x in (kp, vp))
    return q, (kp, vp), (), page_idx, cache_len


def _t(x, kv=None):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if kv == "bf16" else t


def _jax(q, pages, scales, pi, cl):
    """-> (repro's Pallas kernel in interpret mode, repro's oracle)."""
    args = [jnp.asarray(x) for x in (q, *pages, *scales, pi, cl)]
    if scales:
        return (np.asarray(_paged_attn_quant_call(*args, interpret=True)),
                np.asarray(JR.paged_attn_quant_ref(*args)))
    return (np.asarray(JK.paged_attention(*args)),
            np.asarray(JR.paged_attn_ref(*args)))


def _split(q, pages, scales, pi, cl, kv, n_split):
    pps = -(-LANES // n_split)
    n = -(-LANES // pps)
    return TR.paged_attn_split_ref(
        _t(q), *(_t(x, kv) for x in pages), _t(pi), _t(cl), n, pps,
        *(_t(x) for x in scales)).numpy()


@pytest.mark.parametrize("kv", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("n_split", [1, 2, 3, LANES])
def test_split_passes_match_jax(n_split, kv):
    q, pages, scales, pi, cl = _case(n_split, kv)
    got = _split(q, pages, scales, pi, cl, kv, n_split)
    kernel, oracle = _jax(q, pages, scales, pi, cl)
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    assert cl[0] == 0 and not got[0].any() and not kernel[0].any()


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_rows_and_splits_with_nothing_valid(kv):
    """Only -1 lanes, or every split past cache_len: exact zeros, never a
    NaN from -inf - (-inf); a row whose one valid split is its last equals
    the unsplit result."""
    q, pages, scales, pi, cl = _case(7, kv)
    pi[4] = -1                               # a row of -1 lanes only
    cl[5] = 2
    pi[5] = -1
    pi[5, 0] = 3
    for n_split in (2, 3, LANES):
        got = _split(q, pages, scales, pi, cl, kv, n_split)
        assert np.isfinite(got).all()
        assert not got[[0, 4]].any()
        np.testing.assert_allclose(
            got, _split(q, pages, scales, pi, cl, kv, 1), atol=ATOL,
            rtol=RTOL)
    kernel, _ = _jax(q, pages, scales, pi, cl)
    assert not kernel[[0, 4]].any()


def test_plain_version_equals_the_split_passes():
    """The wrappers' plain versions (the CPU path) against the transcription
    at the split count the kernel would pick for this shape on a card of
    132 SMs holding 8 of its CTAs each."""
    n, pps = PA.decode_splits(B, H, KVH, LANES, PS, 132, 8)
    for kv in ("f32", "int8"):
        q, pages, scales, pi, cl = _case(11, kv)
        args = [_t(x) for x in (q, *pages, *scales, pi, cl)]
        plain = (TK.paged_attention_quant(*args) if scales
                 else TK.paged_attention(*args)).numpy()
        got = TR.paged_attn_split_ref(_t(q), *map(_t, pages), _t(pi), _t(cl),
                                      n, pps, *map(_t, scales)).numpy()
        np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)


def test_decode_splits_depend_on_shapes_only():
    # the engine's decode tick: 64 CTAs and 128 positions, one split
    assert PA.decode_splits(8, 32, 8, 8, 16, 132, 8) == (1, 8)
    # the long-context shape: 128 CTAs a split; a wave of 4 CTAs an SM
    # takes four splits of 64 lanes
    assert PA.decode_splits(16, 32, 8, 256, 16, 132, 4) == (4, 64)
    # granite-20b's 48 heads on one KV head: 12 head groups of 4
    assert PA.decode_splits(4, 48, 1, 300, 16, 132, 4) == (11, 28)
    # one query head a KV head: one CTA a head, its other head slots empty
    assert PA.decode_splits(4, 16, 16, 300, 16, 132, 8) == (16, 19)
    assert PA.decode_splits(2, 8, 1, 0, 16, 132, 8) == (1, 0)
    # a split never holds more than MAX_SPLIT_PAGES lanes
    assert PA.decode_splits(64, 32, 8, 20000, 16, 132, 4) == (40, 500)
    rng = np.random.default_rng(0)
    for _ in range(500):
        b, kvh, resident = (int(x) for x in rng.integers(1, 33, 3))
        h = kvh * int(rng.integers(1, 49))
        lanes, ps = int(rng.integers(1, 5000)), int(rng.integers(1, 65))
        n, pps = PA.decode_splits(b, h, kvh, lanes, ps, 132, resident)
        assert 1 <= pps <= PA.MAX_SPLIT_PAGES
        assert (n - 1) * pps < lanes <= n * pps     # no split is empty
        assert n == 1 or pps * ps >= PA.MIN_SPLIT_POSITIONS // 2
        groups = -(-(h // kvh) // PA.DECODE_HEADS)
        assert n == 1 or n * b * kvh * groups <= resident * 132 or \
            pps * 2 > PA.MAX_SPLIT_PAGES                   # one wave
