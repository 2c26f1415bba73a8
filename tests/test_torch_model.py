"""The port's dense model against ``repro.models.model`` on the smoke
config, with the same parameters (``from_jax_params``) and float32
parameters and compute on both sides.

Tolerance: 1e-4 absolute and relative on logits.  Both sides compute in
float32 but sum in different orders (XLA's CPU dot and einsum against
PyTorch's), which moves the last few bits of each product sum; at this
width the logits are O(1) and differ by about 1e-6.  Greedy tokens must be
equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as JC
from repro.dist.sharding import MeshRules
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.models import model as TM

ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cj = dataclasses.replace(JC.get_smoke("llama3.2-1b"),
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke("llama3.2-1b"),
                             compute_dtype=torch.float32)
    jp = JM.init_params(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    return cj, ct, jp, tp, mesh


def test_from_jax_params_keeps_every_leaf(models):
    cj, ct, jp, tp, _ = models
    jl = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in jl:
        node = tp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert len(jl) == sum(1 for _ in _leaves(tp))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("seed", range(3))
def test_prefill_logits_match(models, seed):
    cj, ct, jp, tp, mesh = models
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cj.vocab, (2, 9 + 3 * seed)).astype(np.int32)
    jl, _, jc = JM.forward(jp, cj, {"tokens": jnp.asarray(toks)}, mesh=mesh,
                           rules=MeshRules())
    tl, _, tcache = TM.forward(tp, ct, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jc[k]),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))


def test_decode_steps_and_greedy_tokens_match(models):
    cj, ct, jp, tp, mesh = models
    b, max_seq, prompt_len, n_new = 3, 24, 5, 8
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cj.vocab, (b, prompt_len)).astype(np.int32)
    jcache = JM.init_caches(cj, b, max_seq, dtype=jnp.float32)
    tcache = TM.init_caches(ct, b, max_seq, dtype=torch.float32,
                            device="cpu")
    jcur, tcur = jnp.asarray(prompt[:, :1]), torch.from_numpy(prompt[:, :1])
    jtoks, ttoks = [], []
    for step in range(prompt_len - 1 + n_new):
        clen = np.full((b,), step + 1, np.int32)
        jl, _, jcache = JM.forward(jp, cj, {"tokens": jcur}, mesh=mesh,
                                   rules=MeshRules(), caches=jcache,
                                   cache_len=jnp.asarray(clen))
        tl, _, tcache = TM.forward(tp, ct, {"tokens": tcur}, caches=tcache,
                                   cache_len=torch.from_numpy(clen))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
        if step + 1 < prompt_len:
            jcur = jnp.asarray(prompt[:, step + 1:step + 2])
            tcur = torch.from_numpy(prompt[:, step + 1:step + 2])
        else:
            jn = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)
            tn = tl[:, -1].argmax(-1).to(torch.int32)
            jtoks.append(jn)
            ttoks.append(tn.numpy())
            jcur, tcur = jnp.asarray(jn[:, None]), tn[:, None]
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


def _jax_store(cj, n_pages, ps):
    return JM.init_paged_caches(cj, n_pages, ps, dtype=jnp.float32)


def test_paged_prefill_chunks_and_decode_match(models):
    """The paged data plane on both sides: a prompt prefilled in two
    right-aligned chunks into scattered pages (one row padded, one row
    short), then paged decode steps, against ``repro``'s forward with
    ``pages=``.  Logits and the page store after every step match within
    the tolerance above; greedy tokens are equal.  The JAX store is carried
    into the port's store (which keeps its sink page) through numpy."""
    cj, ct, jp, tp, mesh = models
    ps, lanes, n_pages, b = 4, 6, 20, 2
    rng = np.random.default_rng(5)
    perm = rng.permutation(n_pages)
    pages = np.full((b, lanes), -1, np.int32)
    pages[0, :5] = perm[:5]
    pages[1, :4] = perm[5:9]
    prompt = rng.integers(0, cj.vocab, (b, 11)).astype(np.int32)
    lens = np.asarray([11, 6], np.int32)          # row 1: a shorter prompt
    jstore = _jax_store(cj, n_pages, ps)
    jstore = jax.tree.map(lambda x: x + 0.5, jstore)   # stale page content
    tstore = TM.init_paged_caches(ct, n_pages, ps, dtype=torch.float32,
                                  device="cpu")
    for k in ("k", "v"):
        tstore[k].copy_(torch.from_numpy(np.array(jstore[k])))
    tpages = torch.from_numpy(pages)

    def both(tokens, clen, nl):
        nonlocal jstore
        jl, _, jstore = JM.forward(
            jp, cj, {"tokens": jnp.asarray(tokens)}, mesh=mesh,
            rules=MeshRules(), caches=jstore, cache_len=jnp.asarray(clen),
            pages=jnp.asarray(pages),
            new_lens=None if nl is None else jnp.asarray(nl))
        tl, _, _ = TM.forward(
            tp, ct, {"tokens": torch.from_numpy(tokens)}, caches=tstore,
            cache_len=torch.from_numpy(clen), pages=tpages,
            new_lens=None if nl is None else torch.from_numpy(nl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=RTOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(tstore[k].numpy(),
                                       np.asarray(jstore[k]), atol=ATOL,
                                       rtol=RTOL)
        return tl, jl

    # two chunks of width 8: row 0 takes 8 + 3 tokens, row 1 takes 6 + 0
    width = 8
    done = np.zeros(b, np.int32)
    for _ in range(2):
        chunk = np.minimum(lens - done, width)
        toks = np.zeros((b, width), np.int32)
        for i in range(b):
            toks[i, width - chunk[i]:] = prompt[i, done[i]:done[i] + chunk[i]]
        done = done + chunk
        tl, jl = both(toks, done.copy(), chunk.astype(np.int32))
    cur = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    assert (tl[:, -1].argmax(-1).numpy() == cur).all()
    clen = lens.copy()
    for _ in range(4):
        clen = clen + 1
        tl, jl = both(cur[:, None], clen.copy(), None)
        nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), nxt)
        cur = nxt


def test_paged_store_shape_and_sink():
    ct = TC.get_smoke("llama3.2-1b")
    store = TM.init_paged_caches(ct, 8, 4, device="cpu")
    assert tuple(store["k"].shape) == (ct.n_layers, 8, 4, ct.n_kv_heads,
                                       ct.hd)
    assert store["k"].dtype == torch.bfloat16
    from repro_torch.models.transformer import with_sink
    assert with_sink(store["k"][0]).shape[0] == 9
    # the quantized store: int8 pages, float32 scales per (page, KV head),
    # and a sink page behind every leaf, scale rows included
    qs = TM.init_paged_caches(ct, 8, 4, quantized=True, device="cpu")
    kv_shape = (ct.n_layers, 8, 4, ct.n_kv_heads, ct.hd)
    for name, shape, dt in (("k", kv_shape, torch.int8),
                            ("v", kv_shape, torch.int8),
                            ("k_scale", kv_shape[:2] + kv_shape[3:4],
                             torch.float32),
                            ("v_scale", kv_shape[:2] + kv_shape[3:4],
                             torch.float32)):
        assert tuple(qs[name].shape) == shape and qs[name].dtype == dt
        sink = with_sink(qs[name][1])
        assert sink.shape[0] == 9
        sink[8] = 1                       # the sink is past every shown page
        assert not qs[name].any()
    with pytest.raises(ValueError, match="sink"):
        with_sink(torch.zeros(8, 4, ct.n_kv_heads, ct.hd))
