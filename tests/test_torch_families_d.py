"""The four other dense and vlm configs (gemma-2b, granite-20b,
minicpm-2b, phi-3-vision-4.2b) in the port's scheduler-mode ServingEngine
against ``repro``'s, on the CPU through the paged kernels' plain versions,
at each config's own head shape (MQA with hd 32 and 16, hd 12, MHA).

The smoke configs with float32 parameters and compute on both sides; two
requests that share a prompt prefix, served one after the other so the
second rides the prefix cache and copies its boundary page, then a third
beside a fourth.  Tokens must be equal, and both engines must agree on
what the prefix cache did; after ``stop()`` every page is free."""

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
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import scheduler as JS
from repro_torch import configs as TC
from repro_torch.core import registry as TRG
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE
from repro_torch.serving import scheduler as TS

DENSE = ["gemma-2b", "granite-20b", "minicpm-2b", "phi-3-vision-4.2b"]
SC = dict(max_slots=4, page_size=4, max_seq=32, prefill_chunk=8,
          prefill_rows=2, token_budget=16)
N_PAGES = 32


def _serve(eng, mod, waves, max_new=4):
    reqs = []
    eng.start()
    for wave in waves:
        batch = [mod.Request(rid=len(reqs) + i, prompt=p, max_new=max_new)
                 for i, p in enumerate(wave)]
        reqs += batch
        for r in batch:
            eng.submit(r)
        for r in batch:
            assert r.done.wait(timeout=600), "request timed out"
    eng.stop()
    return [r.out.tolist() for r in reqs]


@pytest.mark.parametrize("arch", DENSE)
def test_scheduler_tokens_match_jax_engine(arch, monkeypatch):
    cj = dataclasses.replace(JC.get_smoke(arch), compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke(arch), compute_dtype=torch.float32)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    monkeypatch.setattr(JRG, "next_lock_id", itertools.count(900).__next__)
    monkeypatch.setattr(TRG, "next_lock_id", itertools.count(900).__next__)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jeng = JE.ServingEngine(cj, jp, mesh=mesh, rules=MeshRules(),
                            n_pages=N_PAGES,
                            scheduler=JS.SchedulerConfig(**SC))
    teng = TE.ServingEngine(ct, tp, n_pages=N_PAGES, device="cpu",
                            scheduler=TS.SchedulerConfig(**SC))
    rng = np.random.default_rng(11)
    base = rng.integers(1, cj.vocab, 10).astype(np.int32)
    waves = [[base], [base[:7].copy()],
             [rng.integers(1, cj.vocab, n).astype(np.int32)
              for n in (9, 13)]]
    with mesh:
        want = _serve(jeng, JE, waves)
    got = _serve(teng, TE, waves)
    assert got == want
    keys = ("pages_saved", "cow_copies", "cached_tokens", "prefills")
    assert {k: getattr(teng.stats, k) for k in keys} == \
        {k: getattr(jeng.stats, k) for k in keys}
    assert teng.stats.pages_saved >= 1
    assert teng.kv_pool.free_count() == N_PAGES
