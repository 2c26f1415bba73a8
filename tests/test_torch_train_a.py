"""The port's training loss and its gradients against ``repro`` on the CPU,
at every arch's smoke config (hubert-xlarge's audio family included):
``models.model.loss_fn``, autograd's gradients against ``jax.grad``, the
four recomputation policies, the audio family's forward, and the masked
online softmax's gradients on padded and bidirectional shapes.

Parameters come from ``repro.models.model.init_params`` through
``from_jax_params``; float32 parameters and compute on both sides; inputs
from a numpy seed.  Tolerances: loss, aux and ``nll_mean`` within 1e-5
relative (they differ by at most ~2e-7 here); each gradient leaf within
2e-5 of its largest element (the two sum in different orders; observed
at most ~4e-6, on the RWKV and Mamba leaves); a recomputation policy's
gradients equal to ``none``'s within 1e-6 of the largest (recomputing
runs the same operations on the same inputs; observed equal)."""

import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.ft.checkpoint import tree_flatten, tree_unflatten
from repro_torch.models import common as TCm
from repro_torch.models import model as TM
from repro_torch.training.train_step import remat_policy_by_name

from torch_train_cases import (MESH, RULES, batch, jax_batch, models, np32,
                               pairs, rel_err, torch_batch)

LOSS_REL = 1e-5
GRAD_REL = 2e-5
REMAT_REL = 1e-6
ARCHS = list(TC.ARCH_IDS)
POLICIES = ["full", "dots", "dots_no_batch"]


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    cj = models(arch)[0]

    def f(p, bb):
        return JM.loss_fn(p, cj, bb, mesh=MESH, rules=RULES)

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _jax_loss_and_grads(arch, b):
    with MESH:
        (total, aux), g = _jax_value_and_grad(arch)(models(arch)[2],
                                                    jax_batch(b))
    return total, aux, g


def _port_loss_and_grads(ct, tp, b, policy=None):
    leaves, treedef = tree_flatten(tp)
    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    total, aux = TM.loss_fn(tree_unflatten(treedef, ps), ct, torch_batch(b),
                            remat_policy=policy)
    gs = torch.autograd.grad(total, ps, allow_unused=True)
    return total, aux, tree_unflatten(treedef, [
        torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_repro(arch):
    """Unmasked and masked batches: the total, the loss, the MoE aux term
    and ``nll_mean`` of the port's ``loss_fn`` equal ``repro``'s."""
    cj, ct, _, tp = models(arch)
    for seed, mask in ((0, False), (1, True)):
        b = batch(cj, seed, mask=mask)
        jt, jaux, _ = _jax_loss_and_grads(arch, b)
        with torch.no_grad():
            tt, taux = TM.loss_fn(tp, ct, torch_batch(b))
        assert abs(float(tt) - float(jt)) <= LOSS_REL * abs(float(jt))
        for k in ("loss", "aux", "nll_mean"):
            assert abs(float(taux[k]) - float(jaux[k])) \
                <= LOSS_REL * max(abs(float(jaux[k])), 1e-30), k


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    cj, ct, _, tp = models(arch)
    b = batch(cj, 2, mask=True)
    _, _, jg = _jax_loss_and_grads(arch, b)
    _, _, tg = _port_loss_and_grads(ct, tp, b)
    for name, j, t in pairs(jg, tg):
        assert t.dtype == torch.float32, name
        assert np.isfinite(np32(t)).all(), name
        assert rel_err(t, j) <= GRAD_REL, (name, rel_err(t, j))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_gradients_of_none(arch, policy):
    cj, ct, _, tp = models(arch)
    b = batch(cj, 3)
    l0, _, g0 = _port_loss_and_grads(ct, tp, b)
    l1, _, g1 = _port_loss_and_grads(ct, tp, b,
                                     remat_policy_by_name(policy))
    assert float(l1.detach()) == float(l0.detach())
    for a, c in zip(tree_flatten(g0)[0], tree_flatten(g1)[0]):
        assert rel_err(c, a) <= REMAT_REL


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["none"] + POLICIES)
def test_remat_policy_recomputes_what_it_names(policy):
    """What the backward pass runs, counted op by op on the dense smoke
    model: ``none`` recomputes nothing (no ``exp`` of the softmax, two
    products back for each forward product); ``full`` recomputes the
    blocks' products; ``dots`` keeps every product's output and recomputes
    the softmax; ``dots_no_batch`` keeps the weight products (``mm``) and
    recomputes the attention's batched ones (``bmm``)."""
    _, ct, _, tp = models("llama3.2-1b")
    b = torch_batch(batch(ct, 4))
    leaves, treedef = tree_flatten(tp)
    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    fwd, bwd = _Count(), _Count()
    with fwd:
        total, _ = TM.loss_fn(tree_unflatten(treedef, ps), ct, b,
                              remat_policy=remat_policy_by_name(policy))
    with bwd:
        torch.autograd.grad(total, ps)
    f, k = fwd.n, bwd.n
    mm_more = k.get("mm", 0) > 2 * f["mm"]
    bmm_more = k.get("bmm", 0) > 2 * f["bmm"]
    # the loss's log-sum-exp calls exp in the backward pass once
    exp_back = k.get("exp", 0) > f.get("exp", 0)
    want = {"none": (False, False, False), "full": (True, True, True),
            "dots": (False, False, True),
            "dots_no_batch": (False, True, True)}[policy]
    assert (mm_more, bmm_more, exp_back) == want, (f, k)


def test_backward_writes_nothing_in_place_that_autograd_saved():
    """Every family's loss and gradients under anomaly detection, with no
    recomputation and with full recomputation: the MoE dispatch's
    ``index_put_``, the RWKV/Mamba chunked scans and the layer loops
    modify no tensor autograd saved, and no backward op yields NaN."""
    for arch in ARCHS:
        cj, ct, _, tp = models(arch)
        b = batch(cj, 5, B=2, S=8)
        for policy in (None, remat_policy_by_name("full")):
            with torch.autograd.detect_anomaly():
                _, _, g = _port_loss_and_grads(ct, tp, b, policy)
            for t in tree_flatten(g)[0]:
                assert torch.isfinite(t).all(), arch


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "bidirectional"])
@pytest.mark.parametrize("sq,skv,bq,bkv", [(13, 13, 4, 8), (5, 13, 8, 4),
                                           (16, 16, 4, 4)])
def test_flash_attention_gradients_are_finite_and_exact(sq, skv, bq, bkv,
                                                        causal):
    """The masked online softmax under autograd, on shapes whose padded
    rows and columns and whole masked blocks (causal, q block before a kv
    block) meet ``-inf`` in ``exp`` and ``where``: the gradients are
    finite and equal a dense softmax's within 1e-5 of the largest."""
    rng = np.random.default_rng(sq * 100 + skv)
    H, KVH, hd = 4, 2, 8
    q0 = torch.from_numpy(rng.normal(size=(2, sq, H, hd)).astype(np.float32))
    k0 = torch.from_numpy(rng.normal(size=(2, skv, KVH, hd))
                          .astype(np.float32))
    v0 = torch.from_numpy(rng.normal(size=(2, skv, KVH, hd))
                          .astype(np.float32))
    off = skv - sq if causal else 0
    w = torch.from_numpy(rng.normal(size=(2, sq, H, hd)).astype(np.float32))

    def grads(attn):
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))
        (attn(q, k, v) * w).sum().backward()
        return q.grad, k.grad, v.grad

    def flash(q, k, v):
        return TCm.flash_attention(q, k, v, causal=causal, block_q=bq,
                                   block_kv=bkv, q_offset=off)

    def dense(q, k, v):
        kg = k.repeat_interleave(H // KVH, dim=2)
        vg = v.repeat_interleave(H // KVH, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kg) / hd ** 0.5
        if causal:
            qp = off + torch.arange(sq)[:, None]
            s = s.masked_fill(torch.arange(skv)[None, :] > qp, -torch.inf)
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vg)

    for got, want in zip(grads(flash), grads(dense)):
        assert torch.isfinite(got).all()
        assert rel_err(got, want) <= 1e-5


def test_audio_forward_matches_repro():
    """hubert's encoder (bidirectional attention, no rope, GELU MLP, frame
    embeddings in, no embedding table, untied head): the logits of every
    position within 1e-5 of the largest, argmax equal."""
    cj, ct, jp, tp = models("hubert-xlarge")
    assert "embed" not in tp and "lm_head" in tp
    b = batch(cj, 6, B=2, S=11)
    del b["labels"]
    with MESH:
        jl, _, _ = jax.jit(lambda p, bb: JM.forward(
            p, cj, bb, mesh=MESH, rules=RULES, make_caches=False))(
                jp, jax_batch(b))
    with torch.no_grad():
        tl, _, _ = TM.forward(tp, ct, torch_batch(b), make_caches=False)
    assert rel_err(tl, jl) <= 1e-5
    assert (np32(tl).argmax(-1) == np.asarray(jl).argmax(-1)).all()
    # bidirectional: the first position sees the last
    b2 = {k: v.copy() for k, v in b.items()}
    b2["embeds"][:, -1] += 1.0
    with torch.no_grad():
        tl2, _, _ = TM.forward(tp, ct, torch_batch(b2), make_caches=False)
    assert not torch.allclose(tl2[:, 0], tl[:, 0])
