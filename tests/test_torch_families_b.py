"""The port's whole models against ``repro`` on the CPU, for every
registered decoder config but llama3.2-1b (tests/test_torch_model.py; the
encoder-only hubert-xlarge is tests/test_torch_train_a.py's): the forward
pass and the caches it returns, ``init_caches``' layouts and dtypes, decode
steps on those caches, the prefill-vs-decode consistency that
tests/test_models.py asserts, and the errors for what a family cannot do.

Parameters come from ``repro.models.model.init_params`` through
``from_jax_params``; float32 parameters and compute on both sides; tokens
from a numpy seed.  Tolerance: 1e-5 of the largest logit or cache value
(the two sum in different orders; they differ by about 1e-6 here).  The
decode steps run on float32 caches: in bf16 a difference of 1e-7 can
round one cache entry a bf16 step apart (it did, in the hybrid's V cache),
which the engine tests (tests/test_torch_families_c.py) meet instead on
tokens."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as JC
from repro.dist.sharding import MeshRules
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import scheduler as JS
from repro.serving.steps import make_decode_step as j_decode_step
from repro.serving.steps import make_prefill_step as j_prefill_step
from repro_torch import configs as TC
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE
from repro_torch.serving import scheduler as TS
from repro_torch.serving.steps import make_decode_step, make_prefill_step

REL = 1e-5
ARCHS = [a for a in TC.ARCH_IDS if a != "llama3.2-1b"
         and TC.get_smoke(a).family != "audio"]
UNPAGED = [a for a in ARCHS if TC.get_smoke(a).family
           in ("moe", "ssm", "hybrid")]
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _models(arch):
    cj = dataclasses.replace(JC.get_smoke(arch), compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke(arch), compute_dtype=torch.float32)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _leaves(jtree, ttree):
    """(path, jax leaf, port leaf) for every leaf of the JAX tree."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = ttree
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), leaf, node


def _close(got, want, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (what, err)


@functools.lru_cache(maxsize=None)
def _jax_forward_fn(cj):
    return jax.jit(lambda p, t, c, cl: JM.forward(
        p, cj, {"tokens": t}, mesh=MESH, rules=MeshRules(), caches=c,
        cache_len=cl))


def _jax_forward(cj, jp, toks, caches=None, cache_len=None):
    with MESH:
        return _jax_forward_fn(cj)(jp, jnp.asarray(toks), caches, cache_len)


def test_from_jax_params_keeps_every_leaf_of_every_family():
    for arch in ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
                 "rwkv6-7b", "zamba2-2.7b"):
        _, _, jp, tp = _models(arch)
        n = 0
        for name, j, t in _leaves(jp, tp):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
            n += 1
        assert n == sum(1 for _ in TM.leaves(tp))


def test_from_jax_params_keeps_bf16_leaves():
    """The configs that serve bf16 parameters: a bf16 JAX tree arrives as
    bf16 tensors with the same bits."""
    cj = dataclasses.replace(JC.get_smoke("llama4-maverick-400b-a17b"),
                             param_dtype=jnp.bfloat16)
    ct = dataclasses.replace(TC.get_smoke("llama4-maverick-400b-a17b"),
                             param_dtype=torch.bfloat16)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(1),
                                                   cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    for name, j, t in _leaves(jp, tp):
        assert t.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16), name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_its_caches_match_repro(arch):
    cj, ct, jp, tp = _models(arch)
    toks = _tokens(cj, 0, 2, 9)
    jl, jaux, jc = _jax_forward(cj, jp, toks)
    tl, taux, tc = TM.forward(tp, ct, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, "logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert torch.equal(tl.argmax(-1), torch.from_numpy(
        np.asarray(jl).argmax(-1)))
    n = 0
    for name, j, t in _leaves(jc, tc):
        assert str(t.dtype) == "torch." + j.dtype.name, name
        _close(t, j, name)
        n += 1
    assert n == sum(1 for _ in TM.leaves(tc))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_repros_layout(arch):
    cj, ct, _, _ = _models(arch)
    jc = JM.init_caches(cj, 3, 16)
    tc = TM.init_caches(ct, 3, 16, device="cpu")
    n = 0
    for name, j, t in _leaves(jc, tc):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype) == "torch." + j.dtype.name, name
        assert not t.any(), name
        n += 1
    assert n == sum(1 for _ in TM.leaves(tc))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_repro(arch):
    """Six decode steps from zero caches (float32), each step's logits and
    every returned cache leaf within tolerance, greedy tokens equal."""
    cj, ct, jp, tp = _models(arch)
    toks = _tokens(cj, 1, 2, 6)
    jc = JM.init_caches(cj, 2, 8, dtype=jnp.float32)
    tc = TM.init_caches(ct, 2, 8, dtype=torch.float32, device="cpu")
    for t in range(toks.shape[1]):
        clen = np.full((2,), t + 1, np.int32)
        jl, _, jc = _jax_forward(cj, jp, toks[:, t:t + 1], caches=jc,
                                 cache_len=jnp.asarray(clen))
        tl, _, tc = TM.forward(tp, ct,
                               {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                               caches=tc, cache_len=torch.from_numpy(clen))
        _close(tl, jl, f"step {t}")
        assert torch.equal(tl.argmax(-1), torch.from_numpy(
            np.asarray(jl).argmax(-1)))
        for name, j, c in _leaves(jc, tc):
            assert str(c.dtype) == "torch." + j.dtype.name, name
            _close(c, j, f"step {t} {name}")


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "phi-3-vision-4.2b"])
def test_prefill_decode_consistency(arch):
    """tests/test_models.py's check on the port: decoding the prompt token
    by token into bf16 caches reproduces the prefill's next-token logits
    (the vlm's image-embed prefix cannot be replayed through decode).  The
    MoE prefill's dispatch drops tokens over capacity where decode is
    dropless, so there only the correlation is held."""
    ct = TC.get_smoke(arch)
    params = TM.init_params(2, ct, device="cpu")
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(ct, 2, B, S))
    last, _ = make_prefill_step(ct)(params, {"tokens": toks})
    decode = make_decode_step(ct)
    caches = TM.init_caches(ct, B, 32, dtype=torch.bfloat16, device="cpu")
    logits = None
    for i in range(S):
        clen = torch.full((B,), i + 1, dtype=torch.int32)
        _, logits, caches = decode(params, caches, toks[:, i:i + 1], clen)
    a, b = last.float().numpy(), logits.float().numpy()
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    if ct.moe_experts:
        assert corr > 0.95, corr
    else:
        np.testing.assert_allclose(a, b, rtol=0.15, atol=0.3)
        assert corr > 0.99, corr


def test_prefill_and_decode_steps_match_repros_steps():
    """The serving steps themselves, on the hybrid (the family whose
    decode mixes returned state and in-place K/V): the prefill step's
    last logits, then two decode steps' tokens and logits."""
    cj, ct, jp, tp = _models("zamba2-2.7b")
    toks = _tokens(cj, 3, 2, 5)
    with MESH:
        jlast, _ = jax.jit(j_prefill_step(cj, MESH, MeshRules()))(
            jp, {"tokens": jnp.asarray(toks)})
    tlast, _ = make_prefill_step(ct)(tp, {"tokens": torch.from_numpy(toks)})
    _close(tlast, jlast)
    jd = jax.jit(j_decode_step(cj, MESH, MeshRules()))
    td = make_decode_step(ct)
    jc = JM.init_caches(cj, 2, 8, dtype=jnp.float32)
    tc = TM.init_caches(ct, 2, 8, dtype=torch.float32, device="cpu")
    for t in range(2):
        clen = np.full((2,), t + 1, np.int32)
        with MESH:
            jn, jl, jc = jd(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(clen))
        tn, tl, tc = td(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                        torch.from_numpy(clen))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        _close(tl, jl)


def _error(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return type(ei.value), str(ei.value)


@pytest.mark.parametrize("arch", UNPAGED)
def test_families_without_dense_attention_refuse_the_page_store(arch):
    """``forward(pages=...)``, ``init_paged_caches`` and scheduler mode
    (which builds the page store) raise ``repro``'s ``ValueError`` with
    its message."""
    cj, ct, jp, tp = _models(arch)
    jerr = _error(lambda: JM.init_paged_caches(cj, 8, 4))
    assert jerr[0] is ValueError
    assert _error(lambda: TM.init_paged_caches(ct, 8, 4,
                                               device="cpu")) == jerr
    toks = np.ones((1, 1), np.int32)
    pages = np.zeros((1, 2), np.int32)
    jerr = _error(lambda: JM.forward(
        jp, cj, {"tokens": jnp.asarray(toks)}, mesh=MESH, rules=MeshRules(),
        caches={}, cache_len=jnp.ones((1,), jnp.int32),
        pages=jnp.asarray(pages)))
    assert jerr[0] is ValueError
    assert _error(lambda: TM.forward(
        tp, ct, {"tokens": torch.from_numpy(toks)}, caches={},
        cache_len=torch.ones((1,), dtype=torch.int32),
        pages=torch.from_numpy(pages))) == jerr
    jerr = _error(lambda: JE.ServingEngine(
        cj, jp, mesh=MESH, rules=MeshRules(), n_pages=8,
        scheduler=JS.SchedulerConfig(max_slots=2, page_size=4)))
    assert jerr[0] is ValueError
    assert _error(lambda: TE.ServingEngine(
        ct, tp, n_pages=8, device="cpu",
        scheduler=TS.SchedulerConfig(max_slots=2, page_size=4))) == jerr


def test_audio_family_is_not_ported_yet():
    """The audio family is ported for training and has no decode step:
    serving hubert-xlarge's smoke config fails as it does in ``repro``,
    with the same exception type and message, from ``init_caches``,
    ``init_paged_caches``, the decode step and the engine in handler and
    scheduler mode."""
    cj = JC.get_smoke("hubert-xlarge")
    ct = TC.get_smoke("hubert-xlarge")
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    cases = [
        (lambda: JM.init_caches(cj, 1, 8),
         lambda: TM.init_caches(ct, 1, 8, device="cpu")),
        (lambda: JM.init_paged_caches(cj, 8, 4),
         lambda: TM.init_paged_caches(ct, 8, 4, device="cpu")),
        (lambda: j_decode_step(cj, MESH, MeshRules()),
         lambda: make_decode_step(ct)),
        (lambda: JE.ServingEngine(cj, jp, mesh=MESH, rules=MeshRules()),
         lambda: TE.ServingEngine(ct, tp, device="cpu")),
        (lambda: JE.ServingEngine(
            cj, jp, mesh=MESH, rules=MeshRules(), n_pages=8,
            scheduler=JS.SchedulerConfig(max_slots=2, page_size=4)),
         lambda: TE.ServingEngine(
             ct, tp, n_pages=8, device="cpu",
             scheduler=TS.SchedulerConfig(max_slots=2, page_size=4))),
    ]
    for jax_make, port_make in cases:
        jerr = _error(jax_make)
        assert jerr[0] is ValueError
        assert _error(port_make) == jerr
