"""The port's optimizer and train step against ``repro`` on the CPU:
``lr_schedule`` for the three schedules, ``adamw_update`` on float32 and
on bf16 state, ``make_train_step`` with microbatches at every arch's smoke
config, on bf16 parameters, and the twin of tests/test_models.py's
``test_smoke_train_step`` over every arch.

Parameters come from ``repro``'s init through ``from_jax_params``; inputs
from a numpy seed; float32 compute where a tolerance must be tight.
Tolerances:
* learning rates within 1e-6 of the peak rate (float32 on both sides;
  ``cos`` may differ in its last bit, and ``1 + cos`` near the end of the
  cosine cancels, so a relative bound would not hold there);
* float32 ``adamw_update``: new parameters, moments and the gradient norm
  within 1e-6 relative of the largest element (the norm's sum runs in
  another order; observed ~1e-7);
* bf16 state: the port runs the update math in bf16, rounding after each
  operation as ``repro``'s code reads, while XLA on the CPU fuses the
  chain and keeps it in float32 (its float32 leaves come back with bits
  no bf16 has), so every element is held within one bf16 rounding, 2**-7
  of its own magnitude;
* ``make_train_step``: loss and gradient norm within 1e-5 relative; each
  element's update (new minus old) within ``lr * (1e-3 + 2e-5 * max|g| /
  (|g| + eps))``, where ``g`` is ``repro``'s clipped gradient (its first
  moment over ``1 - b1``) and 2e-5 of the largest is the gradient
  tolerance of tests/test_torch_train_a.py: AdamW's first step moves an
  element by ``g / (|g| + eps)``, whose slope is at most ``1 / (|g| +
  eps)``, so an element near eps carries the gradient's absolute error
  into its update magnified; the moments within 1e-4 of their largest
  element; bf16 leaves within one bf16 step on at most 1% of elements.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch import configs as TC
from repro_torch.ft.checkpoint import tree_flatten
from repro_torch.training import optimizer as TO
from repro_torch.training import train_step as TT

from torch_train_cases import (MESH, RULES, batch, jax_batch, models, np32,
                               pairs, rel_err, torch_batch)

ARCHS = list(TC.ARCH_IDS)
LR_REL = 1e-6
F32_REL = 1e-6
BF16_SHARE = 0.01
BF16_REL = 2 ** -7
STEP_LOSS_REL = 1e-5
GRAD_REL = 2e-5
UPDATE_OF_LR = 1e-3
MOMENT_REL = 1e-4


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_lr_schedule_matches_repro(schedule):
    kw = dict(lr=2e-3, warmup_steps=7, total_steps=60, schedule=schedule,
              wsd_decay_frac=0.25)
    jo = JO.OptimizerConfig(**kw)
    to = TO.OptimizerConfig(**kw)
    steps = np.arange(0, 70, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: JO.lr_schedule(jo, s))(steps))
    got = TO.lr_schedule(to, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LR_REL * kw["lr"])


def _tree(seed):
    """A parameter-shaped tree with float32 and bf16 leaves, out of
    insertion order so the sorted-key flattening matters, and its
    gradients."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    p = {"z": arr(5, 3), "a": {"w": arr(4, 6), "b": arr(6)},
         "m": arr(3, 2, 2)}
    g = {"z": arr(5, 3, scale=3.0), "a": {"w": arr(4, 6, scale=0.01),
                                          "b": arr(6, scale=2.0)},
         "m": arr(3, 2, 2, scale=0.5)}
    bf16 = {"m"}
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) if k in bf16
          else jax.tree.map(jnp.asarray, v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) if k in bf16
          else jax.tree.map(torch.from_numpy, v) for k, v in p.items()}
    jg = {k: jnp.asarray(v).astype(jnp.bfloat16) if k in bf16
          else jax.tree.map(jnp.asarray, v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v).to(torch.bfloat16) if k in bf16
          else jax.tree.map(torch.from_numpy, v) for k, v in g.items()}
    return jp, tp, jg, tg


def _bf16_steps(got, want):
    """How many bf16 steps apart each element is (bits as int16)."""
    a = torch.as_tensor(np.asarray(want).view(np.int16).astype(np.int32))
    b = got.contiguous().view(torch.int16).to(torch.int32)
    return (a - b).abs()


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_adamw_update_matches_repro(state):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    jo = JO.OptimizerConfig(state_dtype=getattr(jnp, state), **kw)
    to = TO.OptimizerConfig(state_dtype=getattr(torch, state), **kw)
    jp, tp, _, _ = _tree(0)
    js, ts = JO.adamw_init(jp, jo), TO.adamw_init(tp, to)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    upd = jax.jit(lambda p, g, s: JO.adamw_update(p, g, s, jo))
    for k in range(3):
        _, _, jg, tg = _tree(k + 1)
        jp, js, jn = upd(jp, jg, js)
        tp, ts, tn = TO.adamw_update(tp, tg, ts, to)
        assert int(ts["step"]) == int(js["step"]) == k + 1
        assert abs(float(tn) - float(jn)) <= F32_REL * float(jn)
        for tree_j, tree_t in ((jp, tp), (js["m"], ts["m"]),
                               (js["v"], ts["v"])):
            for name, j, t in pairs(tree_j, tree_t):
                assert str(t.dtype) == "torch." + j.dtype.name, name
                if state == "bfloat16":
                    d = np.abs(np32(t) - np32(j))
                    assert (d <= BF16_REL * np.abs(np32(j))).all(), (name, k)
                else:
                    assert rel_err(t, j) <= F32_REL, (name, k)


@functools.lru_cache(maxsize=None)
def _jax_step(arch, compute, param, tcfg, opt):
    cj = models(arch, compute, param)[0]
    with MESH:
        return jax.jit(JT.make_train_step(cj, opt, MESH, RULES, tcfg))


def _compare_steps(arch, tkw, okw, compute="float32", param=None,
                   seed=0, norm_rel=STEP_LOSS_REL):
    cj, ct, jp, tp = models(arch, compute, param)
    jt = JT.TrainConfig(**tkw)
    tt = TT.TrainConfig(**tkw)
    jo = JO.OptimizerConfig(**{k: getattr(jnp, v) if k == "state_dtype"
                               else v for k, v in okw.items()})
    to = TO.OptimizerConfig(**{k: getattr(torch, v) if k == "state_dtype"
                               else v for k, v in okw.items()})
    b = batch(cj, seed, B=4, S=12)
    js0, ts0 = JO.adamw_init(jp, jo), TO.adamw_init(tp, to)
    with MESH:
        jp1, js1, jm = _jax_step(arch, compute, param, jt, jo)(
            jp, js0, jax_batch(b))
    tp1, ts1, tm = TT.make_train_step(ct, to, tt)(tp, ts0, torch_batch(b))
    assert int(tm["step"]) == int(jm["step"]) == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= STEP_LOSS_REL * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        <= norm_rel * float(jm["grad_norm"])
    lr = float(JO.lr_schedule(jo, jnp.asarray(1)))
    return (jp, tp, jp1, tp1, js1, ts1, lr)


def _update_bound(lr, m, bf16=False):
    """The elementwise bound on a step's update difference (module
    docstring), from ``repro``'s first moment ``m``."""
    g = np.abs(np32(m)) / 0.1              # repro's clipped gradient
    grad_rel = BF16_REL / 2 if bf16 else GRAD_REL
    return lr * (UPDATE_OF_LR + grad_rel * g.max() / (g + 1e-8))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_with_microbatches_matches_repro(arch):
    """``TrainConfig(remat="full", microbatches=2)``: loss, gradient
    norm, every leaf's update and both moments equal ``repro``'s step."""
    jp, tp, jp1, tp1, js1, ts1, lr = _compare_steps(
        arch, dict(remat="full", microbatches=2),
        dict(lr=1e-3, warmup_steps=0))
    for (name, j0, t0), (_, j1, t1), (_, m, _) in zip(
            pairs(jp, tp), pairs(jp1, tp1), pairs(js1["m"], ts1["m"])):
        assert t1.dtype == t0.dtype, name
        d = np.abs((np32(t1) - np32(t0)) - (np32(j1) - np32(j0)))
        bound = _update_bound(lr, m)
        assert (d <= bound).all(), (name, (d / bound).max())
    for key in ("m", "v"):
        for name, j, t in pairs(js1[key], ts1[key]):
            assert rel_err(t, j) <= MOMENT_REL, (key, name, rel_err(t, j))


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_train_step_on_bf16_parameters_matches_repro(state):
    """minicpm's smoke config with bf16 parameters (as its full config
    keeps them), microbatches accumulated in ``state``'s dtype: every
    leaf comes back bf16.  The gradients are bf16 leaves on both sides,
    and where two bf16 cotangents cancel (the tied embedding's gather and
    head) the sum keeps an absolute error of half a bf16 step of the
    addends: the gradient norm and the first moment are held within 2**-8
    of their largest, the second moment (a square) within 2**-7; each parameter within the update bound with 2**-8 of
    the leaf's largest gradient in place of 2e-5, plus one bf16 step of
    itself for its own rounding, and at most 1% of the parameters differ
    at all."""
    jp, tp, jp1, tp1, js1, ts1, lr = _compare_steps(
        "minicpm-2b", dict(remat="none", microbatches=2, accum_dtype=state),
        dict(lr=1e-3, warmup_steps=0, state_dtype=state), param="bfloat16",
        norm_rel=BF16_REL / 2)
    for (name, j, t), (_, m, _) in zip(pairs(jp1, tp1),
                                       pairs(js1["m"], ts1["m"])):
        assert t.dtype == torch.bfloat16, name
        d = np.abs(np32(t) - np32(j))
        bound = _update_bound(lr, m, bf16=True) + BF16_REL * np.abs(np32(j))
        assert (d <= bound).all(), (name, (d / bound).max())
        assert float((d > 0).mean()) <= BF16_SHARE, name
    for key in ("m", "v"):
        for name, j, t in pairs(js1[key], ts1[key]):
            assert str(t.dtype) == "torch." + j.dtype.name
            rel = BF16_REL / 2 if key == "m" else BF16_REL
            assert rel_err(t, j) <= rel, (key, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """tests/test_models.py's check on the port: the smoke config as
    published (bf16 compute), ``remat="full"``, two microbatches, default
    optimizer: a finite positive loss, step 1, parameters moved."""
    cfg = TC.get_smoke(arch)
    params = models(arch, "bfloat16")[3]
    b = torch_batch(batch(cfg, 0, B=4, S=16))
    opt = TO.OptimizerConfig()
    state = TO.adamw_init(params, opt)
    step = TT.make_train_step(cfg, opt,
                              TT.TrainConfig(remat="full", microbatches=2))
    p2, s2, metrics = step(params, state, b)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert int(s2["step"]) == 1
    d0 = tree_flatten(params)[0][1]
    d1 = tree_flatten(p2)[0][1]
    assert not np.allclose(np32(d0), np32(d1))


def test_gradient_norm_is_accurate_over_a_large_leaf():
    """The clip's global norm over a leaf of 2**22 float32 elements within
    1e-6 of the float64 norm (a float32 accumulation in the norm kernel
    drifted by 8e-5 at this size, and by 5e-5 on llama3.2-1b's 2.6e8
    embedding gradients)."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=1 << 22).astype(np.float32))
    params = {"w": torch.zeros_like(g), "b": torch.zeros(3)}
    grads = {"w": g, "b": torch.ones(3)}
    opt = TO.OptimizerConfig()
    _, _, gnorm = TO.adamw_update(params, grads, TO.adamw_init(params, opt),
                                  opt)
    want = float(np.sqrt((g.double() ** 2).sum() + 3.0))
    assert abs(float(gnorm) - want) <= 1e-6 * want
