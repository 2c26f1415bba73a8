"""The decode step with a scalar ``cache_len``: ``repro``'s uniform-length
branch (every row writes its K/V at ``cache_len - 1``; the dry-run
serve-step contract, ``launch/dryrun.py``'s decode cell) against the
port's, at the dense smoke configs.  Float32 parameters, compute and
caches; four steps from zero caches on the same tokens: each step's next
tokens equal, its logits and the caches within ``REL`` of the largest
element.  The port raised ``ValueError`` for a scalar length before."""

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
from repro.serving.steps import make_decode_step as j_decode_step
from repro_torch import configs as TC
from repro_torch.models import model as TM
from repro_torch.serving.steps import make_decode_step

REL = 1e-5
ARCHS = [a for a in TC.ARCH_IDS if TC.get_smoke(a).family == "dense"]
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
B, MAX_SEQ, STEPS = 3, 8, 4


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_scalar_cache_len_decode_matches_repro(arch):
    cj = dataclasses.replace(JC.get_smoke(arch), compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke(arch), compute_dtype=torch.float32)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    jc = JM.init_caches(cj, B, MAX_SEQ, dtype=jnp.float32)
    tc = TM.init_caches(ct, B, MAX_SEQ, dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, ct.vocab, (B, STEPS)).astype(np.int32)
    jd = jax.jit(j_decode_step(cj, MESH, MeshRules()))
    td = make_decode_step(ct)
    for i in range(STEPS):
        clen = i + 1
        jn, jl, jc = jd(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                        jnp.int32(clen))
        tn, tl, tc = td(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                        torch.tensor(clen, dtype=torch.int32))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        _close(tl, jl, (arch, i, "logits"))
        for name in ("k", "v"):
            _close(tc[name], jc[name], (arch, i, name))
