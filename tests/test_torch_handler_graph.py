"""Handler mode's steps and the copy-on-write page copy as CUDA graphs
(``serving.steps.jit_step``, where ``repro`` jits them), on the CPU
through the stand-in graph of tests/test_torch_graph_step.py
(``FakeGraph``, ``fake_capture``).

Each handler thread has its own prefill and decode step objects at each
batch size and its own decode cache tree, zeroed in place at the start of
each batch and donated to the decode step, which writes every leaf in
place.  Through warm-up, capture and replay the handler engine must give
``repro``'s engine's tokens on the smoke config of every handler family
(float32 parameters and compute, bf16 caches); the counts must be one
warm-up and one capture a step object, and one more of each for every new
parameter tree it sees.  The page copy must equal the eager indexed copy
byte for byte on both stores, capturing once."""

import dataclasses
import functools
import threading
import time

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
from repro_torch.benchmarks import smoke as SM
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE
from repro_torch.serving import steps as S
from test_torch_graph_step import fake_graphs  # noqa: F401

FAMILIES = ["llama3.2-1b", "phi3.5-moe-42b-a6.6b",
            "llama4-maverick-400b-a17b", "rwkv6-7b", "zamba2-2.7b"]
LENS = (6, 3, 5)
MAX_NEW = 4
STEPS = max(LENS) - 1 + MAX_NEW          # decode calls a batch


@functools.lru_cache(maxsize=None)
def _models(arch):
    cj = dataclasses.replace(JC.get_smoke(arch), compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke(arch), compute_dtype=torch.float32)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


def _requests(mod, vocab, batches, seed=5, lens=LENS):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(1, vocab, n)
                        .astype(np.int32), max_new=MAX_NEW)
            for i, n in enumerate(list(lens) * batches)]


def _serve(eng, reqs, **start_kw):
    """All requests queued before ``start``, so one handler takes them in
    order, ``slots_per_handler`` at a time."""
    for r in reqs:
        eng.submit(r)
    eng.start(**start_kw)
    for r in reqs:
        assert r.done.wait(timeout=600), "request timed out"
    eng.stop()
    return [r.out.tolist() for r in reqs]


def _counts(stats):
    return stats["warmups"], stats["captures"], stats["replays"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_graphed_handler_tokens_match_jax_engine(fake_graphs, arch):
    """Three batches of the same shapes through one handler: the decode
    step warms up, captures and replays across batches (one cache tree,
    zeroed in place each batch), the prefill warms up, captures, replays;
    every token equals ``repro``'s engine."""
    cj, ct, jp, tp = _models(arch)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jeng = JE.ServingEngine(cj, jp, mesh=mesh, rules=MeshRules(),
                            handlers=1, max_seq=16,
                            slots_per_handler=len(LENS))
    teng = TE.ServingEngine(ct, tp, handlers=1, max_seq=16,
                            slots_per_handler=len(LENS), device="cpu")
    with mesh:
        want = _serve(jeng, _requests(JE, cj.vocab, 3))
    got = _serve(teng, _requests(TE, ct.vocab, 3))
    assert got == want
    assert teng.stats.decode_steps == jeng.stats.decode_steps == 3 * STEPS
    steps = teng.handler_step_stats()
    assert list(steps) == [f"h0_b{len(LENS)}"]
    st = steps[f"h0_b{len(LENS)}"]
    assert _counts(st["prefill"]) == (1, 1, 2)
    assert _counts(st["decode"]) == (1, 1, 3 * STEPS - 1)
    assert st["decode"]["capture_at"] == [2]


def test_handler_prefill_copies_out_its_logits_only(fake_graphs):
    """Handler mode reads nothing of the prefill's result, so its graph
    returns the last position's logits alone and a replay copies no cache
    out of the pool."""
    _, ct, _, tp = _models("llama3.2-1b")
    eng = TE.ServingEngine(ct, tp, handlers=1, max_seq=16,
                           slots_per_handler=2, device="cpu")
    hs = eng._handler_steps(0, 2)
    batch = {"tokens": torch.arange(1, 7, dtype=torch.int32).view(2, 3)}
    want = TM.forward(tp, ct, batch, last_only=True)[0][:, -1]
    for _ in range(3):                   # warm-up, capture, replay
        out = hs.prefill(tp, batch)
        assert torch.equal(out, want)
    assert _counts(dataclasses.asdict(hs.prefill.stats)) == (1, 1, 2)
    assert hs.prefill._captured.plan[0] == "fresh"


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_second_batch_equals_a_fresh_engine(fake_graphs, arch):
    """The per-handler cache tree is zeroed between batches: a batch
    served second (after one whose recurrent state and K/V filled the
    tree) gives a fresh engine's tokens, through the same tree and the
    same graph."""
    _, ct, _, tp = _models(arch)
    first = _requests(TE, ct.vocab, 1, seed=8)
    second = _requests(TE, ct.vocab, 1, seed=9)
    eng = TE.ServingEngine(ct, tp, handlers=1, max_seq=16,
                           slots_per_handler=len(LENS), device="cpu")
    eng.start()
    outs = []
    for reqs in (first, second):
        for r in reqs:
            eng.submit(r)
        for r in reqs:
            assert r.done.wait(timeout=600)
        outs.append([r.out.tolist() for r in reqs])
        if reqs is first:
            hs = eng._hsteps[(0, len(LENS))]
            tree = hs.caches
            filled = [x.clone() for x in S.flatten(tree)[0]]
            assert any(bool(x.any()) for x in filled)
    assert eng._hsteps[(0, len(LENS))].caches is tree
    eng.stop()
    fresh = TE.ServingEngine(ct, tp, handlers=1, max_seq=16,
                             slots_per_handler=len(LENS), device="cpu")
    assert outs[1] == _serve(fresh, _requests(TE, ct.vocab, 1, seed=9))
    dec = eng.handler_step_stats()[f"h0_b{len(LENS)}"]["decode"]
    assert _counts(dec) == (1, 1, 2 * STEPS - 1)


def test_each_thread_and_batch_size_has_its_own_steps(fake_graphs):
    """One handler: a batch of 3, then a batch of 2, each size with its
    own step objects and cache tree.  Two handlers: each thread's steps
    are its own objects, and every call of each is a warm-up or a
    replay."""
    _, ct, _, tp = _models("llama3.2-1b")
    eng = TE.ServingEngine(ct, tp, handlers=1, max_seq=16,
                           slots_per_handler=3, device="cpu")
    reqs = _requests(TE, ct.vocab, 1) + _requests(TE, ct.vocab, 1,
                                                  lens=LENS[:2])
    for i, r in enumerate(reqs):
        r.rid = i
    _serve(eng, reqs)
    st = eng.handler_step_stats()
    assert sorted(st) == ["h0_b2", "h0_b3"]
    for key in st:
        assert _counts(st[key]["prefill"]) == (1, 0, 0)
        assert _counts(st[key]["decode"]) == (1, 1, STEPS - 1)
    a, b = eng._hsteps[(0, 3)], eng._hsteps[(0, 2)]
    assert a.decode is not b.decode and a.prefill is not b.prefill
    assert a.caches is None and b.caches is None     # dropped by stop()

    eng = TE.ServingEngine(ct, tp, handlers=2, max_seq=16,
                           slots_per_handler=2, device="cpu")
    reqs = _requests(TE, ct.vocab, 4, lens=(5, 5))
    for i, r in enumerate(reqs):
        r.rid = i
    _serve(eng, reqs)
    objs = list(eng._hsteps.values())
    assert len({id(hs.decode) for hs in objs}) == len(objs)
    st = eng.handler_step_stats()
    calls = sum(s["decode"]["warmups"] + s["decode"]["replays"]
                for s in st.values())
    assert calls == eng.stats.decode_steps
    assert all(s["decode"]["captures"] <= s["decode"]["warmups"]
               for s in st.values())


def test_a_swap_costs_each_step_one_warm_up_and_one_capture(fake_graphs):
    """Two batches, a hot swap, two more: each step object that sees the
    new tree runs it once eagerly and captures it once; the tokens equal
    the eager engine's under the same swap."""
    _, ct, _, tp = _models("phi3.5-moe-42b-a6.6b")
    outs = {}
    for arm in ("graph", "eager"):
        eng = TE.ServingEngine(ct, tp, handlers=1, max_seq=16,
                               slots_per_handler=len(LENS), device="cpu")
        if arm == "eager":
            SM.eager_steps(eng)
        eng.start()
        outs[arm] = []
        for b in range(4):
            if b == 2:
                assert eng.hot_swap(TE._perturb(eng.store.params))
            reqs = _requests(TE, ct.vocab, 1, seed=20 + b)
            for r in reqs:
                eng.submit(r)
            for r in reqs:
                assert r.done.wait(timeout=600)
            outs[arm] += [r.out.tolist() for r in reqs]
        eng.stop()
        if arm == "graph":
            st = eng.handler_step_stats()[f"h0_b{len(LENS)}"]
        else:
            assert eng.handler_step_stats() == {"h0_b3": {}}
    assert outs["graph"] == outs["eager"]
    assert _counts(st["prefill"]) == (2, 2, 2)
    assert _counts(st["decode"]) == (2, 2, 4 * STEPS - 2)
    assert st["decode"]["warmup_at"] == [1, 2 * STEPS + 1]


def test_stop_drops_the_graphs_and_the_cache_trees(fake_graphs):
    _, ct, _, tp = _models("llama3.2-1b")
    eng = TE.ServingEngine(ct, tp, handlers=1, max_seq=16,
                           slots_per_handler=len(LENS), device="cpu")
    _serve(eng, _requests(TE, ct.vocab, 1))
    hs = eng._hsteps[(0, len(LENS))]
    assert isinstance(hs.decode, S.GraphedStep)
    assert hs.decode.donate_argnums == (1,)
    assert hs.decode._captured is None and hs.caches is None
    assert eng.lock_stats()["handler_steps"] == eng.handler_step_stats()


def test_decode_caches_take_the_dtypes_the_step_returns():
    """Zamba2's convolution window beside float32 weights, and RWKV's
    token shifts at float32 compute, come back from the step in float32:
    the engine's tree holds them so from the start (zeros), so the step
    can write them in place; the step on that tree equals the step on
    ``init_caches``'s."""
    for arch, promoted in (("zamba2-2.7b", ["mamba.conv"]),
                           ("rwkv6-7b", ["shift1", "shift2"])):
        _, ct, _, tp = _models(arch)
        eng = TE.ServingEngine(ct, tp, handlers=1, max_seq=8,
                               slots_per_handler=2, device="cpu")
        tree = eng._decode_caches(2)
        init = TM.init_caches(ct, 2, 8, device="cpu")
        names = _names(init)
        for name, x, y in zip(names, S.flatten(tree)[0],
                              S.flatten(init)[0]):
            assert not x.any() and x.shape == y.shape
            want = torch.float32 if name in promoted else y.dtype
            assert x.dtype == want, (arch, name, x.dtype)
        tok = torch.tensor([[3], [7]], dtype=torch.int32)
        clen = torch.ones(2, dtype=torch.int32)
        a = eng._decode(tp, tree, tok, clen)
        b = S.make_decode_step(ct)(tp, init, tok, clen)
        assert a[2] is tree
        assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
        for x, y in zip(S.flatten(tree)[0], S.flatten(b[2])[0]):
            assert torch.equal(x, y)


def _names(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += _names(v, f"{prefix}{k}.") if isinstance(v, dict) \
            else [prefix + k]
    return out


def test_in_place_writes_the_result_into_the_donated_argument():
    def step(w, state, x):
        return x * w, {"a": state["a"] + x, "b": state["b"]}

    run = S.in_place(step, arg=1, out=1)
    state = {"a": torch.zeros(3), "b": torch.ones(2)}
    a, b = state["a"], state["b"]
    y, got = run(torch.tensor(2.0), state, torch.arange(3.0))
    assert got is state and state["a"] is a and state["b"] is b
    assert torch.equal(a, torch.arange(3.0)) and torch.equal(y, 2 * a)
    with pytest.raises(ValueError, match="does not fit"):
        S.in_place(lambda s: ({"a": s["a"].double()},), arg=0, out=0)(
            {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure"):
        S.in_place(lambda s: ({"b": s["a"]},), arg=0, out=0)(
            {"a": torch.zeros(2)})


def test_captures_run_one_at_a_time(monkeypatch):
    """Two threads capturing at once would share ``torch.cuda.graph``'s
    one side stream: ``capture_graph`` serializes them."""
    inside, overlaps = [0], []

    class Graph:
        pass

    class Ctx:
        def __init__(self, graph, capture_error_mode):
            assert capture_error_mode == "thread_local"

        def __enter__(self):
            inside[0] += 1
            overlaps.append(inside[0])
            time.sleep(0.05)

        def __exit__(self, *exc):
            inside[0] -= 1

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Ctx)
    threads = [threading.Thread(target=S.capture_graph,
                                args=(lambda x: x + 1, (torch.ones(1),)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert overlaps == [1, 1, 1, 1]


# ---------------------------------------------------------------------------
# The copy-on-write page copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_copy_page_is_byte_exact_and_captures_once(fake_graphs, quant):
    """Four copy-on-writes through a scheduler engine's graphed copy (the
    page pair as device scalars, so one graph serves every pair): each
    leaf, the int8 store's scales too, equal byte for byte to the eager
    indexed copy of ``repro``'s ``x.at[:, dst].set(x[:, src])``."""
    cfg = TC.get_smoke("llama3.2-1b")
    params = TM.init_params(0, cfg, device="cpu")
    sc = TE.SchedulerConfig(max_slots=2, page_size=4, max_seq=32,
                            prefill_chunk=4)
    eng = TE.ServingEngine(cfg, params, n_pages=16, scheduler=sc,
                           quant_kv=quant, device="cpu")
    g = torch.Generator().manual_seed(3)
    for x in eng._pages_kv.values():
        x.copy_(torch.randn(x.shape, generator=g).to(x.dtype)
                if x.is_floating_point()
                else torch.randint(-127, 128, x.shape, generator=g,
                                   dtype=x.dtype))
    want = {k: v.clone() for k, v in eng._pages_kv.items()}
    assert len(want) == (4 if quant else 2)
    for src, dst in ((3, 10), (5, 11), (10, 12), (15, 0)):
        eng._copy_page(src, dst)
        for x in want.values():
            x[:, dst] = x[:, src]
        for k, x in eng._pages_kv.items():
            assert torch.equal(x.contiguous().view(torch.uint8),
                               want[k].contiguous().view(torch.uint8)), k
    st = dataclasses.asdict(eng._copy_page_step.stats)
    assert _counts(st) == (1, 1, 3)
    assert eng._copy_page_step.donate_argnums == (0,)
    eng.stop()
    assert eng._copy_page_step._captured is None


def test_copy_page_on_cpu_tensors_is_the_eager_copy():
    store = {"k": torch.arange(24.0).reshape(2, 4, 3)}
    want = store["k"].clone()
    want[:, 1] = want[:, 3]
    pair = torch.tensor([3, 1], dtype=torch.int32)
    assert TE.copy_page(store, pair[0], pair[1]) is store
    assert torch.equal(store["k"], want)
