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
