"""The train step as one CUDA graph (``training.train_step.jit_train_step``,
where ``repro``'s call sites ``jax.jit`` it with the trees donated).

On the CPU the capture-and-replay flow runs on the stand-in graph of
tests/test_torch_graph_step.py (``FakeGraph``, ``fake_capture``): the
graphed step must give the eager ``make_train_step``'s loss, gradient norm
and updates within tests/test_torch_train_b.py's bounds, write them into
the trees it was given, and capture once.  The repairs the capture needed
are pinned on the meta device, where a tensor made on the host and moved
to the device inside the step shows: the optimizer's constants, the loss's
auxiliary term and the batch's move.  The restart stays bit for bit
through the graph, and no call site (the examples, ``chip_smoke.py``)
reads a tree it passed to the step after the call."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as TC
from repro_torch.ft.checkpoint import tree_flatten, tree_unflatten
from repro_torch.models import model as TM
from repro_torch.serving import steps as S
from repro_torch.training import optimizer as TO
from repro_torch.training import train_step as TT
from test_torch_graph_step import fake_graphs  # noqa: F401
from test_torch_train_b import (GRAD_REL, MOMENT_REL, STEP_LOSS_REL,
                                _jax_step, _update_bound)
from torch_train_cases import (MESH, batch, jax_batch, models, np32, pairs,
                               rel_err, torch_batch)

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS = 3
CASES = [("llama3.2-1b", "dots"), ("phi3.5-moe-42b-a6.6b", "full"),
         ("rwkv6-7b", "none"), ("zamba2-2.7b", "none"),
         ("hubert-xlarge", "full")]


def _clone(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x.clone() for x in leaves])


def _setup(arch, remat, microbatches=2):
    cfg = dataclasses.replace(TC.get_smoke(arch),
                              compute_dtype=torch.float32)
    params = TM.init_params(0, cfg, device="cpu")
    opt = TO.OptimizerConfig(lr=1e-3, warmup_steps=0)
    tcfg = TT.TrainConfig(remat=remat, microbatches=microbatches)
    return cfg, params, opt, tcfg


@pytest.mark.parametrize("arch,remat", CASES)
def test_graphed_step_matches_the_eager_step(fake_graphs, arch, remat):
    """Three steps, microbatches of 2: a warm-up, a capture that
    replays, a replay.  Each graphed step starts from the eager step's trees
    and must return the very trees it was given, updated in place; loss,
    norm, every update and both moments within the bounds of
    tests/test_torch_train_b.py."""
    cfg, params, opt, tcfg = _setup(arch, remat)
    eager = TT.make_train_step(cfg, opt, tcfg)
    graphed = TT.jit_train_step(cfg, opt, tcfg)
    state = TO.adamw_init(params, opt)
    gp, gs = _clone(params), _clone(state)
    lr = float(TO.lr_schedule(opt, torch.tensor(1)))
    for i in range(STEPS):
        b = batch(cfg, i, B=4, S=16, mask=cfg.family == "audio")
        old = _clone(gp)
        p1, s1, m1 = eager(params, state, b)
        p2, s2, m2 = graphed(gp, gs, b)
        assert p2 is gp and s2 is gs
        assert int(m2["step"]) == int(m1["step"]) == i + 1
        assert abs(float(m2["loss"]) - float(m1["loss"])) \
            <= STEP_LOSS_REL * abs(float(m1["loss"]))
        assert abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) \
            <= GRAD_REL * float(m1["grad_norm"])
        for x0, x1, x2, m in zip(*(tree_flatten(t)[0] for t in (
                old, p1, gp, s1["m"]))):
            d = np.abs((np32(x2) - np32(x0)) - (np32(x1) - np32(x0)))
            assert (d <= _update_bound(lr, m)).all(), (arch, i)
        for key in ("m", "v"):
            for a, b_ in zip(tree_flatten(s1[key])[0],
                             tree_flatten(gs[key])[0]):
                assert rel_err(b_, a) <= MOMENT_REL, (arch, i, key)
        # the eager arm goes on from where the graphed one stands
        params, state = _clone(gp), _clone(gs)
    st = graphed.graph.stats
    assert (st.warmups, st.captures, st.replays) == (1, 1, STEPS - 1)
    assert st.capture_at == [2]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge"])
def test_graphed_replay_matches_repro(fake_graphs, arch):
    """A replay of the graphed step against ``repro``'s jitted step on the
    same batch from the same trees: the step warms up and captures on the
    trees, which are then put back as they were, in place (the graph's
    key holds), and replayed.  Loss, gradient norm, every leaf's update
    and both moments within tests/test_torch_train_b.py's bounds."""
    import repro.training.optimizer as JO
    import repro.training.train_step as JT

    tkw, okw = dict(remat="full", microbatches=2), dict(lr=1e-3,
                                                       warmup_steps=0)
    cj, ct, jp, tp = models(arch)
    jo, to = JO.OptimizerConfig(**okw), TO.OptimizerConfig(**okw)
    b = batch(cj, 0, B=4, S=12)
    js0 = JO.adamw_init(jp, jo)
    with MESH:
        jp1, js1, jm = _jax_step(arch, "float32", None, JT.TrainConfig(**tkw),
                                 jo)(jp, js0, jax_batch(b))
    step = TT.jit_train_step(ct, to, TT.TrainConfig(**tkw))
    gp = _clone(tp)
    gs = TO.adamw_init(gp, to)
    start = [x.clone() for x in tree_flatten((gp, gs))[0]]
    for _ in range(2):                   # the warm-up, the capture
        gp, gs, _ = step(gp, gs, torch_batch(b))
    for x, x0 in zip(tree_flatten((gp, gs))[0], start):
        x.copy_(x0)
    gp, gs, tm = step(gp, gs, torch_batch(b))
    st = step.graph.stats
    assert (st.warmups, st.captures, st.replays) == (1, 1, 2)
    assert int(tm["step"]) == int(jm["step"]) == 1
    assert abs(float(tm["loss"]) - float(jm["loss"])) \
        <= STEP_LOSS_REL * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        <= STEP_LOSS_REL * float(jm["grad_norm"])
    lr = float(JO.lr_schedule(jo, np.asarray(1)))
    for (name, j0, _), (_, j1, t1), (_, m, _), t0 in zip(
            pairs(jp, gp), pairs(jp1, gp), pairs(js1["m"], gs["m"]),
            start):
        d = np.abs((np32(t1) - np32(t0)) - (np32(j1) - np32(j0)))
        bound = _update_bound(lr, m)
        assert (d <= bound).all(), (name, (d / bound).max())
    for key in ("m", "v"):
        for name, j, t in pairs(js1[key], gs[key]):
            assert rel_err(t, j) <= MOMENT_REL, (key, name, rel_err(t, j))


def test_new_trees_cost_a_warm_up_and_a_capture(fake_graphs):
    """A restore hands the step new trees: one eager step, one capture,
    then replays, as after a hot swap in serving."""
    cfg, params, opt, tcfg = _setup("llama3.2-1b", "none", 1)
    step = TT.jit_train_step(cfg, opt, tcfg)
    state = TO.adamw_init(params, opt)
    for i in range(3):
        params, state, _ = step(params, state, batch(cfg, i))
    params, state = _clone(params), _clone(state)
    for i in range(3):
        params, state, _ = step(params, state, batch(cfg, 3 + i))
    st = step.graph.stats
    assert (st.warmups, st.captures, st.replays) == (2, 2, 4)
    assert st.warmup_at == [1, 4] and st.capture_at == [2, 5]
    step.graph.reset()
    assert step.graph._captured is None


def test_in_place_update_equals_the_pure_update():
    """``adamw_update_`` writes ``adamw_update``'s values leaf by leaf into
    the trees it is given, bit for bit, on float32 and bf16 state."""
    rng = np.random.default_rng(0)
    for sd in (torch.float32, torch.bfloat16):
        opt = TO.OptimizerConfig(lr=1e-2, warmup_steps=0, state_dtype=sd)
        params = {"a": torch.from_numpy(rng.normal(size=(5, 3)).astype(
                      np.float32)),
                  "b": {"c": torch.from_numpy(rng.normal(size=7).astype(
                      np.float32))}}
        grads = {"a": torch.ones(5, 3), "b": {"c": torch.arange(7.0)}}
        state = TO.adamw_init(params, opt)
        for _ in range(3):
            p1, s1, n1 = TO.adamw_update(params, grads, state, opt)
            p2, s2 = _clone(params), _clone(state)
            n2 = TO.adamw_update_(p2, grads, s2, opt)
            assert torch.equal(n1, n2)
            for x, y in zip(tree_flatten((p1, s1))[0],
                            tree_flatten((p2, s2))[0]):
                assert x.dtype == y.dtype and torch.equal(x, y)
            params, state = p1, s1


# ---------------------------------------------------------------------------
# The repairs the capture needs, on the meta device
# ---------------------------------------------------------------------------


class _Moves(TorchDispatchMode):
    """Records every operation that takes a host tensor and gives a
    tensor on another device: a copy to the device, which a CUDA graph
    cannot hold."""

    def __init__(self):
        super().__init__()
        self.moves = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {x.device.type for x in torch.utils._pytree.tree_leaves(
            (args, kwargs)) if isinstance(x, torch.Tensor)}
        outs = {x.device.type for x in torch.utils._pytree.tree_leaves(out)
                if isinstance(x, torch.Tensor)}
        if "cpu" in ins and outs - {"cpu"}:
            self.moves.append(str(func))
        return out


@pytest.fixture
def host_made(monkeypatch):
    """Every ``torch.tensor``/``torch.as_tensor`` call that makes a tensor
    off the host from host data (no operation dispatches for it)."""
    made = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def spy(data, *a, _real=real, _name=name, **kw):
            out = _real(data, *a, **kw)
            if out.device.type != "cpu" and not (
                    isinstance(data, torch.Tensor)
                    and data.device == out.device):
                made.append(_name)
            return out
        monkeypatch.setattr(torch, name, spy)
    return made


@pytest.mark.parametrize("arch,remat", [("llama3.2-1b", "full"),
                                        ("phi3.5-moe-42b-a6.6b", "none")])
def test_graphed_step_moves_nothing_from_the_host(fake_graphs, host_made,
                                                  arch, remat):
    """The graphed step on meta tensors, given a numpy batch: the batch
    reaches the graph on the parameters' device (``_on`` before the input
    copy), and nothing inside the step (the optimizer's constants, the
    loss's auxiliary term for a family without MoE) is made on the host
    and moved over."""
    cfg = TC.get_smoke(arch)
    params = TM.init_params(0, cfg, device="meta")
    opt = TO.OptimizerConfig()
    state = TO.adamw_init(params, opt)
    step = TT.jit_train_step(cfg, opt, TT.TrainConfig(remat=remat,
                                                      microbatches=2))
    b = batch(cfg, 0)
    on_dev = TT._on(b, torch.device("meta"))     # what the wrapper does
    for _ in range(3):                      # warm-up, capture, replay
        made = len(host_made)
        with _Moves() as spy:
            params, state, m = step.graph.fn(params, state, on_dev)
        assert spy.moves == [] and len(host_made) == made, \
            (spy.moves, host_made)
        params, state, m = step(params, state, b)
    assert m["loss"].device.type == "meta"
    bufs = step.graph._captured.bufs
    assert bufs and all(x.device.type == "meta" for x in bufs)


def test_eager_pure_step_leaves_its_inputs_alone():
    """``make_train_step`` stays pure: the trees it is given are unchanged
    and new ones come back."""
    cfg, params, opt, tcfg = _setup("llama3.2-1b", "none", 1)
    state = TO.adamw_init(params, opt)
    before = _clone((params, state))
    p1, s1, _ = TT.make_train_step(cfg, opt, tcfg)(params, state,
                                                   batch(cfg, 0))
    assert p1 is not params and s1 is not state
    for x, y in zip(tree_flatten(before)[0],
                    tree_flatten((params, state))[0]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The call sites
# ---------------------------------------------------------------------------


CALL_SITES = [ROOT / "src/repro_torch/examples/quickstart.py",
              ROOT / "src/repro_torch/examples/elastic_restart.py",
              ROOT / "chip_smoke.py"]


def _trees_of(call, names):
    """The two tree arguments of a call of a step in ``names``, called
    directly (``step(p, s, b)``) or through a helper that takes the step
    first (``timed(step, p, s, b)``); None for any other call."""
    if isinstance(call.func, ast.Name) and call.func.id in names:
        return call.args[:2]
    if call.args and isinstance(call.args[0], ast.Name) \
            and call.args[0].id in names:
        return call.args[1:3]
    return None


def _scopes(tree):
    """The module and every top-level function: a step's name is bound
    and called within one of them (nested functions included)."""
    yield [n for n in tree.body if not isinstance(n, ast.FunctionDef)]
    for n in tree.body:
        if isinstance(n, ast.FunctionDef):
            yield [n]


@pytest.mark.parametrize("path", CALL_SITES, ids=lambda p: p.name)
def test_call_sites_rebind_the_trees_they_pass(path):
    """Every call of a step made by ``jit_train_step`` passes two names
    and rebinds those same names to the first two results, so the site
    reads no tree it passed as the tree before the step (the graph
    updated it in place, as a donated buffer is gone in ``repro``)."""
    checked = 0
    for scope in _scopes(ast.parse(path.read_text())):
        nodes = [n for top in scope for n in ast.walk(top)]
        names = {t.id for n in nodes if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Call)
                 and getattr(n.value.func, "id", None) == "jit_train_step"
                 for t in n.targets if isinstance(t, ast.Name)}
        for n in nodes:
            if not names or not isinstance(n, (ast.Assign, ast.Expr)) \
                    or not isinstance(n.value, ast.Call):
                continue
            trees = _trees_of(n.value, names)
            if trees is None:
                continue
            checked += 1
            args = [a.id for a in trees if isinstance(a, ast.Name)]
            assert len(args) == 2 and isinstance(n, ast.Assign), \
                ast.unparse(n)
            tgt = n.targets[0]
            if isinstance(tgt.elts[0], ast.Tuple):  # (p, s, m), t = ...
                tgt = tgt.elts[0]
            got = [e.id if isinstance(e, ast.Name) else ast.unparse(e)
                   for e in tgt.elts[:2]]
            assert got == args, ast.unparse(n)
    assert checked, f"{path.name}: no call of a jit_train_step step"


def test_restart_is_bit_exact_through_the_graph(fake_graphs, tmp_path):
    """``repro``'s ``test_checkpoint_restart_bit_exact`` through the
    graphed step, as chip_smoke's ``train_restart`` runs it: 6 steps
    straight equal 3 steps, a checkpoint, a restore (new trees: a warm-up
    and a capture again) and 3 steps, bit for bit."""
    from repro_torch.data import DataConfig, make_batches
    from repro_torch.ft.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.ft.elastic import reshard_tree

    cfg = TC.get_smoke("llama3.2-1b")
    opt = TO.OptimizerConfig(lr=1e-3, warmup_steps=0)
    step = TT.jit_train_step(cfg, opt, TT.TrainConfig(remat="none"))
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)

    def run(params, state, start, n):
        params, state = _clone(params), _clone(state)
        it = make_batches(data, start_step=start)
        for _ in range(n):
            params, state, _ = step(params, state, next(it))
        return params, state

    params = TM.init_params(0, cfg, device="cpu")
    state = TO.adamw_init(params, opt)
    pA, _ = run(params, state, 0, 6)
    pB, sB = run(params, state, 0, 3)
    save_checkpoint(tmp_path, 3, {"params": pB, "state": sB})
    like = {"params": pB, "state": sB}
    restored = reshard_tree(load_checkpoint(tmp_path, 3, like), like,
                            device="cpu")
    pC, _ = run(restored["params"], restored["state"], 3, 3)
    for x, y in zip(tree_flatten(pA)[0], tree_flatten(pC)[0]):
        assert torch.equal(x, y)
    st = step.graph.stats
    assert (st.warmups, st.captures, st.replays) == (3, 3, 9)


def test_tree_flatten_keeps_no_leaf_alive():
    """``tree_flatten``/``tree_unflatten`` leave no reference cycle behind:
    a tree they walked is freed when its last name goes, with the garbage
    collector off (a recursive closure's cycle held whole parameter and
    gradient trees until a collection)."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        leaves, treedef = tree_flatten({"a": [leaf, (torch.ones(1),)]})
        tree = tree_unflatten(treedef, leaves)
        assert tree["a"][0] is leaf
        del leaf, leaves, tree
        assert ref() is None
    finally:
        gc.enable()


def test_jit_step_keys_the_trees_by_identity():
    """The step's graph keys parameters and state by identity (donated)
    and the batch by shape."""
    cfg, params, opt, tcfg = _setup("llama3.2-1b", "none", 1)
    step = TT.jit_train_step(cfg, opt, tcfg)
    assert isinstance(step.graph, S.GraphedStep)
    assert step.graph.donate_argnums == (0, 1)
