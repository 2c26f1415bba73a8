"""The plain versions of the paged attention kernels K5 (decode) and K6
(chunk prefill) against ``repro``'s Pallas kernels, run in interpret mode on
the CPU, and against ``repro.kernels.ref``'s oracles, on the same seeded
inputs.

Tolerance: 1e-5 absolute and relative.  Every side computes in float32; the
Pallas kernels walk the pages one at a time with an online softmax, the
port's plain version takes one masked softmax over a dense gather, so the
sums run in another order and the outputs (O(1) here) differ in the last
bits, about 1e-7.  A query with no valid position (``cache_len`` 0, a
padding column, only -1 lanes) must be exactly zero on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro.kernels import ref as JR
from repro_torch.kernels import ops as TK

ATOL = RTOL = 1e-5
HD, N_PAGES, LANES = 16, 24, 5


def _case(seed, b, s, h, kvh, ps, kv_dtype):
    """Seeded inputs with every trap: -1 lanes inside and past cache_len, a
    row with cache_len 0 (and new_lens 0 for a chunk), a partial last page,
    a chunk longer than the paged prefix before it, a position past the
    lanes."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, HD)).astype(np.float32)
    kp = rng.normal(size=(N_PAGES, ps, kvh, HD)).astype(np.float32)
    vp = rng.normal(size=(N_PAGES, ps, kvh, HD)).astype(np.float32)
    if kv_dtype == "bf16":          # both sides read the same rounded pages
        kp = np.asarray(jnp.asarray(kp, jnp.bfloat16).astype(jnp.float32))
        vp = np.asarray(jnp.asarray(vp, jnp.bfloat16).astype(jnp.float32))
    page_idx = np.full((b, LANES), -1, np.int32)
    cache_len = np.zeros((b,), np.int32)
    new_lens = np.zeros((b,), np.int32)
    perm = rng.permutation(N_PAGES)
    for i in range(b - 1):          # the last row stays empty
        nl = int(rng.integers(1, s + 1))
        clen = int(rng.integers(nl, LANES * ps + 1))
        if i == 0:
            clen = nl                 # the chunk is the whole prefix
        if i == 1:
            clen = min(LANES * ps, (clen // ps) * ps + ps // 2)  # partial page
        npg = -(-clen // ps)
        page_idx[i, :npg] = perm[i * LANES:i * LANES + npg]
        if i == 2 and npg > 1:
            page_idx[i, 0] = -1       # a hole inside cache_len
        cache_len[i] = clen
        new_lens[i] = nl
    return q, kp, vp, page_idx, cache_len, new_lens


def _torch(x, kv_dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if kv_dtype == "bf16" else t


CASES = [(seed, s, h, kvh, ps, kvd)
         for seed, (s, h, kvh, ps, kvd) in enumerate(
             [(1, 4, 2, 4, "f32"), (5, 8, 2, 8, "f32"), (8, 4, 2, 4, "bf16"),
              (5, 4, 2, 8, "bf16"), (8, 8, 2, 8, "f32"), (1, 8, 2, 4, "bf16")])]


@pytest.mark.parametrize("seed,s,h,kvh,ps,kvd", CASES)
def test_chunk_attention_matches_pallas_and_oracle(seed, s, h, kvh, ps, kvd):
    q, kp, vp, pi, cl, nl = _case(seed, 5, s, h, kvh, ps, kvd)
    want = np.asarray(JK.paged_chunk_attention(*map(jnp.asarray, (
        q, kp, vp, pi, cl, nl))))
    oracle = np.asarray(JR.paged_chunk_attn_ref(*map(jnp.asarray, (
        q, kp, vp, pi, cl, nl))))
    got = TK.paged_chunk_attention(_torch(q), _torch(kp, kvd),
                                   _torch(vp, kvd), _torch(pi), _torch(cl),
                                   _torch(nl)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    # padding columns and the empty row are exactly zero on both sides
    col = np.arange(s)
    pad = (col[None, :] < s - nl[:, None]) | (cl[:, None] - s + col < 0)
    assert pad[-1].all()
    assert not got[pad].any() and not want[pad].any()


@pytest.mark.parametrize("seed,h,kvh,ps,kvd",
                         [(c[0], c[2], c[3], c[4], c[5]) for c in CASES])
def test_decode_attention_matches_pallas_and_oracle(seed, h, kvh, ps, kvd):
    q, kp, vp, pi, cl, _ = _case(seed, 5, 1, h, kvh, ps, kvd)
    q = q[:, 0]
    cl[1] = LANES * ps + 3            # a length past the lanes: all of them
    want = np.asarray(JK.paged_attention(*map(jnp.asarray, (q, kp, vp, pi,
                                                            cl))))
    oracle = np.asarray(JR.paged_attn_ref(*map(jnp.asarray, (q, kp, vp, pi,
                                                             cl))))
    got = TK.paged_attention(_torch(q), _torch(kp, kvd), _torch(vp, kvd),
                             _torch(pi), _torch(cl)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    assert cl[-1] == 0 and not got[-1].any() and not want[-1].any()


def test_only_minus_one_lanes_give_zeros():
    q, kp, vp, pi, cl, nl = _case(0, 3, 5, 4, 2, 4, "f32")
    pi[:] = -1
    got = TK.paged_chunk_attention(_torch(q), _torch(kp), _torch(vp),
                                   _torch(pi), _torch(cl), _torch(nl))
    assert not got.any()
    got = TK.paged_attention(_torch(q[:, 0]), _torch(kp), _torch(vp),
                             _torch(pi), _torch(cl))
    assert not got.any()


def test_output_takes_q_dtype_and_bad_operands_raise():
    q, kp, vp, pi, cl, nl = _case(0, 3, 5, 4, 2, 4, "bf16")
    qb = _torch(q).to(torch.bfloat16)
    out = TK.paged_chunk_attention(qb, _torch(kp, "bf16"), _torch(vp, "bf16"),
                                   _torch(pi), _torch(cl), _torch(nl))
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="int32"):
        TK.paged_attention(_torch(q[:, 0]), _torch(kp), _torch(vp),
                           _torch(pi).long(), _torch(cl))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TK.paged_attention(_torch(q[:, 0]).double(), _torch(kp), _torch(vp),
                           _torch(pi), _torch(cl))
    with pytest.raises(ValueError, match="contiguous"):
        TK.paged_attention(_torch(q)[:, 0], _torch(kp), _torch(vp),
                           _torch(pi), _torch(cl))


def test_cuda_needs_a_kernel_not_the_plain_version():
    """The wrappers take the plain version only for CPU tensors: a tensor
    on another device type is refused, never computed on the host."""
    q, kp, vp, pi, cl, _ = _case(0, 3, 1, 4, 2, 4, "f32")
    with pytest.raises(ValueError, match="device"):
        TK.paged_attention(_torch(q[:, 0]).to("meta"), _torch(kp),
                           _torch(vp), _torch(pi), _torch(cl))


def test_page_index_past_the_store_is_masked():
    """A lane naming a page past the store (``>= n_pages``) is masked like
    a -1 lane.  The Pallas kernel has no such check (its index map only
    lifts -1 to page 0; ROADMAP.md, Queue 3, R6).  The port equals the JAX
    kernel with that lane set to -1."""
    q, kp, vp, pi, cl, nl = _case(3, 5, 5, 4, 2, 4, "f32")
    bad = pi.copy()
    bad[2, 1] = N_PAGES + 3
    pi[2, 1] = -1
    want = np.asarray(JK.paged_chunk_attention(*map(jnp.asarray, (
        q, kp, vp, pi, cl, nl))))
    got = TK.paged_chunk_attention(_torch(q), _torch(kp), _torch(vp),
                                   _torch(bad), _torch(cl),
                                   _torch(nl)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
