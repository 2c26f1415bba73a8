"""The port's model families, module by module, against ``repro`` on the
CPU: the config copies field for field, the parameter counts, the MoE
layer's two bodies, the chunked linear-attention core and the RWKV-6 and
Mamba-2 blocks.

Inputs come from a numpy seed; parameters from ``repro``'s init functions,
converted leaf by leaf; float32 parameters and compute on both sides.
Tolerance: 1e-5 of the largest output (both sides compute in float32 and
sum in different orders; the outputs here are O(1) and differ by about
1e-7).  The MoE dispatch body's dropped tokens must match exactly."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as JC
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.dist.sharding import MeshRules
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

REL = 1e-5
MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]
MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _f32(cfg, mod):
    return dataclasses.replace(cfg, compute_dtype=mod.float32)


# ---------------------------------------------------------------------------
# Configs and parameter counts
# ---------------------------------------------------------------------------


def test_arch_ids_are_repros_but_audio():
    """Every architecture of ``repro`` is registered, in its order: the
    audio family (hubert-xlarge) is ported too now."""
    assert TC.ARCH_IDS == JC.ARCH_IDS


def _dtype_name(v):
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    return np.dtype(v).name


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_config_copies_field_for_field(arch):
    jcfg, _, jshapes = JC.get(arch)
    tcfg, trules, tshapes = TC.get(arch)
    assert tshapes == jshapes
    assert trules == MeshRules(**dataclasses.asdict(JC.get(arch)[1]))
    for jc, tc in ((jcfg, tcfg), (JC.get_smoke(arch), TC.get_smoke(arch))):
        jf = [f.name for f in dataclasses.fields(jc)]
        assert [f.name for f in dataclasses.fields(tc)] == jf
        for name in jf:
            jv, tv = getattr(jc, name), getattr(tc, name)
            if name.endswith("_dtype"):
                assert _dtype_name(tv) == _dtype_name(jv), name
            else:
                assert tv == jv, name


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_num_params_match_repro_and_published_ranges(arch):
    """The counts from the port's meta-device init equal ``repro``'s from
    ``jax.eval_shape``, and lie in ``repro``'s published ranges
    (tests/test_models.py)."""
    expected = {
        "llama4-maverick-400b-a17b": (380e9, 420e9),
        "phi3.5-moe-42b-a6.6b": (39e9, 45e9),
        "phi-3-vision-4.2b": (3.5e9, 4.5e9),
        "hubert-xlarge": (0.8e9, 1.3e9),
        "minicpm-2b": (2.2e9, 3.1e9),
        "granite-20b": (18e9, 22e9),
        "gemma-2b": (2.2e9, 2.8e9),
        "llama3.2-1b": (1.0e9, 1.5e9),
        "rwkv6-7b": (6e9, 8e9),
        "zamba2-2.7b": (2.3e9, 3.1e9),
    }
    jcfg, _, _ = JC.get(arch)
    tcfg, _, _ = TC.get(arch)
    n = tcfg.num_params()
    assert n == jcfg.num_params()
    assert tcfg.num_active_params() == jcfg.num_active_params()
    lo, hi = expected[arch]
    assert lo <= n <= hi
    assert TC.get_smoke(arch).num_params() == JC.get_smoke(arch).num_params()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_case(arch, seed, rows):
    """(jax cfg, torch cfg, jax params, torch params, x): one MoE layer of
    the smoke config.  ``rows`` "random": a (2, 8) batch of random tokens;
    "padded": left-padded rows, the padding an identical vector (repro's
    token-0 rows); "same": every token identical, so its experts overflow
    their capacity."""
    cj = _f32(JC.get_smoke(arch), jnp)
    ct = _f32(TC.get_smoke(arch), torch)
    jp = jax.tree.map(lambda a: a[0],
                      JT.init_moe(jax.random.PRNGKey(seed), cj, 1))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 8, cj.d_model)).astype(np.float32)
    if rows == "padded":
        x[0, :5] = x[1, :3] = rng.normal(size=cj.d_model)
    elif rows == "same":
        x[:] = rng.normal(size=cj.d_model)
    return cj, ct, jp, _to_torch(jp), x


@functools.lru_cache(maxsize=None)
def _jax_moe_fn(cj, decode_tp, shared):
    return jax.jit(lambda p, x: JT.moe_forward(
        p, x, cj, MESH, ("data",), split_tokens_over_model=True,
        decode_tp=decode_tp))


def _jax_moe(jp, x, cj, decode_tp):
    with MESH:
        return _jax_moe_fn(cj, decode_tp, "shared" in jp)(jp, jnp.asarray(x))


@pytest.mark.parametrize("rows", ["random", "padded", "same"])
@pytest.mark.parametrize("decode_tp", [False, True],
                         ids=["dispatch", "dropless"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_repro(arch, decode_tp, rows):
    cj, ct, jp, tp, x = _moe_case(arch, 3, rows)
    jy, jaux = _jax_moe(jp, x, cj, decode_tp)
    ty, taux = TT.moe_forward(tp, torch.from_numpy(x), ct,
                              decode_tp=decode_tp)
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatch_drops_the_same_tokens(arch):
    """Every token identical: each takes the same experts, so the capacity
    buckets overflow and the later tokens in the flat order are dropped.
    Without the shared expert a token dropped by every choice outputs
    exactly zero: the dropped rows are the same rows on both sides."""
    cj, ct, jp, tp, x = _moe_case(arch, 4, "same")
    jp = {k: v for k, v in jp.items() if k != "shared"}
    tp = {k: v for k, v in tp.items() if k != "shared"}
    jy, _ = _jax_moe(jp, x, cj, False)
    ty, _ = TT.moe_forward(tp, torch.from_numpy(x), ct)
    jdrop = (np.asarray(jy) == 0).all(-1)
    tdrop = (ty.numpy() == 0).all(-1)
    T = x.shape[0] * x.shape[1]
    cap = int(np.ceil(T * cj.moe_top_k * cj.capacity_factor
                      / cj.moe_experts))
    assert jdrop.sum() == T - cap
    np.testing.assert_array_equal(tdrop, jdrop)
    _close(ty, jy)


def test_moe_top_k_ties_go_to_the_lower_expert():
    """A router with equal columns gives equal probabilities: ``lax.top_k``
    picks the lower expert index, and so does the port's route."""
    ct = _f32(TC.get_smoke("phi3.5-moe-42b-a6.6b"), torch)
    router = torch.ones((ct.d_model, ct.moe_experts))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, ct.d_model)).astype(np.float32))
    _, top_p, top_e = TT._route(x, router, ct)
    want_p, want_e = jax.lax.top_k(
        jax.nn.softmax(jnp.asarray(x.numpy()) @ jnp.asarray(router.numpy()),
                       axis=-1), ct.moe_top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want_e))
    assert top_e[:, 0].eq(0).all() and top_e[:, 1].eq(1).all()


def test_expert_products_widen_bf16_exactly():
    """The dispatch body's expert products at bf16 parameters run one
    expert at a time (no float32 copy of the whole stack) and equal the
    float32 product of the widened operands, as
    ``preferred_element_type=float32`` computes it."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn((4, 3, 16), generator=g).bfloat16()
    w = torch.randn((4, 16, 8), generator=g).bfloat16()
    got = TT._expert_mm_f32(a, w)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a.float(), w.float()))


# ---------------------------------------------------------------------------
# The chunked linear-attention core and the SSM blocks
# ---------------------------------------------------------------------------


def _la_inputs(seed, S, inclusive):
    rng = np.random.default_rng(seed)
    B, H, K, V = 2, 3, 8, 6
    q, k = (rng.normal(size=(B, S, H, K)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(B, S, H, V)).astype(np.float32)
    # some log-decays under the clamp, so LOG_DECAY_MIN matters
    shape = (B, S, H, 1) if inclusive else (B, S, H, K)
    lw = -np.exp(rng.normal(size=shape)).astype(np.float32)
    bonus = None if inclusive else rng.normal(size=(H, K)).astype(np.float32)
    state = rng.normal(size=(B, H, K, V)).astype(np.float32)
    return q, k, v, lw, bonus, state


@pytest.mark.parametrize("S,chunk", [(1, 32), (7, 32), (40, 32),
                                     (70, 32), (33, 8)])
@pytest.mark.parametrize("inclusive", [False, True],
                         ids=["rwkv", "mamba"])
def test_chunked_linear_attention_matches_repro(S, chunk, inclusive):
    q, k, v, lw, bonus, state = _la_inputs(S, S, inclusive)
    jb = None if bonus is None else jnp.asarray(bonus)
    tb = None if bonus is None else torch.from_numpy(bonus)
    jy, js = jax.jit(JS.chunked_linear_attention,
                     static_argnames=("inclusive", "chunk"))(
        *map(jnp.asarray, (q, k, v, lw)), bonus=jb, inclusive=inclusive,
        chunk=chunk, state=jnp.asarray(state))
    ty, ts = TS.chunked_linear_attention(
        *map(torch.from_numpy, (q, k, v, lw)), bonus=tb,
        inclusive=inclusive, chunk=chunk, state=torch.from_numpy(state))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("inclusive", [False, True],
                         ids=["rwkv", "mamba"])
def test_linear_attention_step_matches_repro(inclusive):
    q, k, v, lw, bonus, state = _la_inputs(5, 1, inclusive)
    jb = None if bonus is None else jnp.asarray(bonus)
    tb = None if bonus is None else torch.from_numpy(bonus)
    jy, js = JS.linear_attention_step(
        *(jnp.asarray(a[:, 0]) for a in (q, k, v, lw)), jnp.asarray(state),
        bonus=jb, inclusive=inclusive)
    ty, ts = TS.linear_attention_step(
        *(torch.from_numpy(a[:, 0]) for a in (q, k, v, lw)),
        torch.from_numpy(state), bonus=tb, inclusive=inclusive)
    _close(ty, jy)
    _close(ts, js)


def _block_case(arch, init_j, seed):
    cj = _f32(JC.get_smoke(arch), jnp)
    ct = _f32(TC.get_smoke(arch), torch)
    jp = jax.tree.map(lambda a: a[0], init_j(jax.random.PRNGKey(seed), cj, 1))
    return cj, ct, jp, _to_torch(jp)


def _jit_block(fn):
    jf = jax.jit(fn, static_argnames=("cfg",))
    return lambda p, x, cfg, cache=None: jf(p, x, cfg=cfg, cache=cache)


def _run_block(jfn, tfn, jp, tp, cj, ct, x, steps):
    """A prefill over ``x[:, :-steps]`` with no cache, then ``steps``
    single-token steps on the returned cache; every output and cache
    compared."""
    n = x.shape[1] - steps
    jy, jc = jfn(jp, jnp.asarray(x[:, :n]), cj)
    ty, tc = tfn(tp, torch.from_numpy(x[:, :n]), ct)
    _close(ty, jy)
    for t in range(n, x.shape[1]):
        for name in jc:
            _close(tc[name], jc[name])
            assert str(tc[name].dtype) == "torch." + jc[name].dtype.name
        jy, jc = jfn(jp, jnp.asarray(x[:, t:t + 1]), cj, cache=jc)
        ty, tc = tfn(tp, torch.from_numpy(x[:, t:t + 1]), ct, cache=tc)
        _close(ty, jy)


@pytest.mark.parametrize("S", [5, 37])
def test_rwkv6_block_matches_repro(S):
    cj, ct, jp, tp = _block_case("rwkv6-7b", JS.init_rwkv6, S)
    x = np.random.default_rng(S).normal(
        size=(2, S + 3, cj.d_model)).astype(np.float32)
    _run_block(_jit_block(JS.rwkv6_block), TS.rwkv6_block, jp, tp, cj, ct,
               x, 3)


@pytest.mark.parametrize("S", [5, 37])
def test_mamba2_block_matches_repro(S):
    cj, ct, jp, tp = _block_case("zamba2-2.7b", JS.init_mamba2, S)
    x = np.random.default_rng(S).normal(
        size=(2, S + 3, cj.d_model)).astype(np.float32)
    _run_block(_jit_block(JS.mamba2_block), TS.mamba2_block, jp, tp, cj, ct,
               x, 3)


def test_mamba2_decode_from_a_bf16_cache_keeps_repros_dtypes():
    """``init_caches`` holds the conv window in bf16; the first decode step
    returns it in the input projection's dtype (float32 here), as
    ``repro``'s does, and the state stays float32."""
    cj, ct, jp, tp = _block_case("zamba2-2.7b", JS.init_mamba2, 1)
    di, ds = cj.ssm_expand * cj.d_model, cj.ssm_state
    nh = di // JS.MAMBA_HEAD
    x = np.random.default_rng(1).normal(
        size=(2, 1, cj.d_model)).astype(np.float32)
    jc = {"conv": jnp.zeros((2, JS.MAMBA_CONV - 1, di + 2 * ds),
                            jnp.bfloat16),
          "state": jnp.zeros((2, nh, ds, JS.MAMBA_HEAD), jnp.float32)}
    tc = {"conv": torch.zeros((2, TS.MAMBA_CONV - 1, di + 2 * ds),
                              dtype=torch.bfloat16),
          "state": torch.zeros((2, nh, ds, TS.MAMBA_HEAD))}
    jy, jc = JS.mamba2_block(jp, jnp.asarray(x), cj, cache=jc)
    ty, tc = TS.mamba2_block(tp, torch.from_numpy(x), ct, cache=tc)
    _close(ty, jy)
    for name in jc:
        assert str(tc[name].dtype) == "torch." + jc[name].dtype.name
        _close(tc[name], jc[name])


def test_ssm_constants_are_repros():
    assert (TS.CHUNK, TS.LOG_DECAY_MIN) == (JS.CHUNK, JS.LOG_DECAY_MIN)
    assert (TS.RWKV_HEAD, TS.MAA_RANK, TS.DECAY_RANK) == \
        (JS.RWKV_HEAD, JS.MAA_RANK, JS.DECAY_RANK)
    assert (TS.MAMBA_HEAD, TS.MAMBA_CONV) == (JS.MAMBA_HEAD, JS.MAMBA_CONV)
