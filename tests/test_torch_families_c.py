"""The port's handler-mode ServingEngine on the new model families
(``moe``: phi3.5-moe and llama4; ``ssm``: RWKV-6; ``hybrid``: Zamba2)
against ``repro``'s, on the CPU through the kernels' plain versions.

Both engines get the same requests before they start, so one handler
takes them as one batch of left-padded rows on both sides (the padding
rows go through the MoE dispatch and the recurrent state as ``repro``'s
do), with float32 parameters and compute and bf16 caches.  Tokens must be
equal (no near-tie at these seeds).  Then each family serves under weight
hot-swap and compaction, with the lease pair of every step."""

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
from repro_torch import configs as TC
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE

FAMILIES = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
            "rwkv6-7b", "zamba2-2.7b"]
LENS = (6, 3, 5)


@functools.lru_cache(maxsize=None)
def _models(arch):
    cj = dataclasses.replace(JC.get_smoke(arch), compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke(arch), compute_dtype=torch.float32)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


def _requests(mod, vocab, seed=5, max_new=4):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(1, vocab, n)
                        .astype(np.int32), max_new=max_new)
            for i, n in enumerate(LENS)]


def _serve(eng, reqs, **start_kw):
    for r in reqs:
        eng.submit(r)
    eng.start(**start_kw)
    for r in reqs:
        assert r.done.wait(timeout=600), "request timed out"
    eng.stop()
    return [r.out.tolist() for r in reqs]


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_tokens_match_jax_engine(arch):
    cj, ct, jp, tp = _models(arch)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jeng = JE.ServingEngine(cj, jp, mesh=mesh, rules=MeshRules(),
                            handlers=1, max_seq=16,
                            slots_per_handler=len(LENS))
    teng = TE.ServingEngine(ct, tp, handlers=1, max_seq=16,
                            slots_per_handler=len(LENS), device="cpu")
    with mesh:
        want = _serve(jeng, _requests(JE, cj.vocab))
    got = _serve(teng, _requests(TE, ct.vocab))
    assert got == want
    assert teng.stats.prefills == jeng.stats.prefills == 1
    assert teng.stats.decode_steps == jeng.stats.decode_steps


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_serves_the_family_under_swap_and_compaction(arch):
    """Two handlers of two slots, a hot swap every 20 ms and compaction:
    every request finishes with in-vocabulary tokens, the swaps land, and
    after ``stop()`` every page is free and no lease is held."""
    _, ct, _, tp = _models(arch)
    eng = TE.ServingEngine(ct, tp, handlers=2, max_seq=16,
                           slots_per_handler=2, device="cpu")
    reqs = _requests(TE, ct.vocab, seed=6, max_new=6) + \
        _requests(TE, ct.vocab, seed=7, max_new=6)
    for i, r in enumerate(reqs):
        r.rid = i
    outs = _serve(eng, reqs, swap_period_s=0.02, compact_period_s=0.02)
    assert all(len(o) == 6 and all(0 <= t < ct.vocab for t in o)
               for o in outs)
    st = eng.lock_stats()
    assert st["engine"]["weight_swaps"] >= 1
    assert len(eng.pages.free) == eng.kv_pool.n_pages
    locks = [eng.store.leases] + eng.kv_pool.locks
    assert not np.asarray(eng.registry.held_multi(locks)).any()
