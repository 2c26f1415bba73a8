"""``serving.steps.jit_step``, the port's counterpart of ``repro``'s
``jit_step``: on the card a CUDA graph of the serving step, on the CPU the
step itself.

On the CPU (no card here) the wrapper runs the step eagerly, bit for bit.
Its key and binding functions are plain functions of tensors and are
tested as such: what is keyed by identity (the parameter tree, the donated
page store), what by abstract value and copied in, which results are fresh.
The wrapper's capture-and-replay flow runs here on a stand-in for the CUDA
graph (``FakeGraph``): a capture that leaves every argument as it found
it, and a replay that recomputes the step into the captured results, which
is what replaying a graph does to its buffers.  Through it the
scheduler-mode engine must still give ``repro``'s tokens on the smoke
config, on the bf16 and on the int8 store.
"""

import dataclasses
import threading
import weakref

import numpy as np
import pytest
import torch

import test_torch_quant_kv as QKV
from repro_torch import configs as TC
from repro_torch.kernels import _build
from repro_torch.kernels import ops as K
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE
from repro_torch.serving import steps as S
from test_torch_scheduler import SCENARIOS, _drained, models  # noqa: F401

# ---------------------------------------------------------------------------
# A stand-in for the CUDA graph, for the CPU
# ---------------------------------------------------------------------------


class FakeGraph:
    """A captured call on the CPU: :meth:`replay` runs the step again on
    the captured arguments (the input buffers, the parameters, the store)
    and writes its results into the captured results."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out
        self.replays = 0

    def replay(self):
        with _build.recording_launches():      # a replay runs no wrapper
            new = self.fn(*self.args)
        for dst, src in zip(S.flatten(self.out)[0], S.flatten(new)[0]):
            if isinstance(dst, torch.Tensor) and dst is not src:
                dst.copy_(src)
        self.replays += 1


def fake_capture(fn, args):
    """:func:`steps.capture_graph` on the CPU: the call runs (to give the
    results' structure), recording its launches, then every argument is
    put back as it was, since a capture executes nothing."""
    tensors = [x for x in S.flatten(list(args))[0]
               if isinstance(x, torch.Tensor)]
    saved = [x.clone() for x in tensors]
    with _build.recording_launches() as launches:
        out = fn(*args)
    for x, v in zip(tensors, saved):
        x.copy_(v)
    return FakeGraph(fn, args, out), out, dict(launches)


@pytest.fixture
def fake_graphs(monkeypatch):
    """Every graphed step takes its CUDA path, on the stand-in."""
    monkeypatch.setattr(S, "capture_graph", fake_capture)
    monkeypatch.setattr(S, "step_device", lambda args: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


# ---------------------------------------------------------------------------
# A small paged model on the CPU
# ---------------------------------------------------------------------------

N_PAGES, PS, LANES, B = 16, 4, 4, 3


@pytest.fixture(scope="module")
def small():
    cfg = dataclasses.replace(TC.get_smoke("llama3.2-1b"),
                              compute_dtype=torch.float32)
    return cfg, TM.init_params(0, cfg, device="cpu")


def _store(cfg, quant=False, seed=1):
    store = TM.init_paged_caches(cfg, N_PAGES, PS, quantized=quant,
                                 device="cpu")
    g = torch.Generator().manual_seed(seed)
    if not quant:
        for x in store.values():
            x.copy_(torch.randn(x.shape, generator=g).to(x.dtype))
    return store


def _decode_args(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab, (B, 1)).astype(
        np.int32))
    clen = torch.tensor([5, 9, 0], dtype=torch.int32)
    pages = torch.from_numpy(rng.permutation(N_PAGES)[:B * LANES].reshape(
        B, LANES).astype(np.int32))
    return tok, clen, pages


def _prefill_args(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 6)).astype(
        np.int32))
    clen = torch.tensor([6, 11], dtype=torch.int32)
    newl = torch.tensor([6, 4], dtype=torch.int32)
    pages = torch.from_numpy(rng.permutation(N_PAGES)[:2 * LANES].reshape(
        2, LANES).astype(np.int32))
    return toks, clen, newl, pages


def _clone_tree(tree):
    leaves, structure = S.flatten(tree)
    return S.unflatten(structure, [x.clone() for x in leaves])


def _equal_trees(a, b):
    la, sa = S.flatten(a)
    lb, sb = S.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The CPU path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_jit_step_on_cpu_tensors_is_the_step_bit_for_bit(small, quant):
    cfg, params = small
    for make, args in ((lambda: S.make_decode_step(cfg, paged=True),
                        _decode_args(cfg)),
                       (lambda: S.make_paged_prefill_step(cfg),
                        _prefill_args(cfg))):
        bare, graphed = make(), S.jit_step(make(), donate_argnums=(1,))
        s1, s2 = _store(cfg, quant), _store(cfg, quant)
        want = bare(params, s1, *args)
        got = graphed(params, s2, *args)
        assert got[-1] is s2                     # the store, in place
        _equal_trees(list(want[:-1]), list(got[:-1]))
        _equal_trees(s1, s2)
        assert graphed.stats.captures == graphed.stats.replays == 0


def test_step_device_refuses_a_mix_of_devices():
    a = torch.zeros(2)
    assert S.step_device(({"w": a}, a, [a])) == torch.device("cpu")
    with pytest.raises(ValueError, match="one device"):
        S.step_device((a, torch.zeros(2, device="meta")))


# ---------------------------------------------------------------------------
# Keys and binding
# ---------------------------------------------------------------------------


def test_flatten_and_unflatten_invert_each_other():
    a, b, c = torch.zeros(1), torch.ones(2), torch.arange(3)
    tree = {"x": a, "y": [b, (c, 7)], "z": {}}
    leaves, structure = S.flatten(tree)
    assert leaves[:3] == [a, b, c] and leaves[3] == 7
    back = S.unflatten(structure, leaves)
    assert back["x"] is a and back["y"][0] is b and back["y"][1][0] is c
    assert isinstance(back["y"], list) and isinstance(back["y"][1], tuple)
    assert back["y"][1][1] == 7 and back["z"] == {}
    assert S.flatten(back)[1] == structure


def test_key_is_the_same_when_a_copied_argument_changes_its_values(small):
    cfg, params = small
    store = _store(cfg)
    tok, clen, pages = _decode_args(cfg)
    k1 = S.step_key((params, store, tok, clen, pages), (1,))
    k2 = S.step_key((params, store, tok + 1, clen.clone(), pages * 0), (1,))
    assert k1 == k2


@pytest.mark.parametrize("change", ["shape", "dtype", "structure"])
def test_key_changes_with_a_copied_argument_shape_or_dtype(small, change):
    cfg, params = small
    store = _store(cfg)
    tok, clen, pages = _decode_args(cfg)
    other = {"shape": tok[:2], "dtype": tok.long(),
             "structure": [tok]}[change]
    assert S.step_key((params, store, tok, clen, pages), (1,)) \
        != S.step_key((params, store, other, clen, pages), (1,))


def test_key_changes_with_a_new_parameter_tree_or_store(small):
    cfg, params = small
    store = _store(cfg)
    tok, clen, pages = _decode_args(cfg)
    key = S.step_key((params, store, tok, clen, pages), (1,))
    swapped = _clone_tree(params)                # same shapes, new tensors
    assert S.step_key((swapped, store, tok, clen, pages), (1,)) != key
    one_leaf = dict(params, embed=params["embed"].clone())
    assert S.step_key((one_leaf, store, tok, clen, pages), (1,)) != key
    assert S.step_key((params, _store(cfg), tok, clen, pages), (1,)) != key
    # the same tree is the same key, whatever container holds it
    assert S.step_key((dict(params), dict(store), tok, clen, pages),
                      (1,)) == key


def test_donated_store_is_bound_by_identity_and_never_copied(small):
    cfg, params = small
    store = _store(cfg)
    args = (params, store, *_decode_args(cfg))
    bound, bufs = S.bind_inputs(args, (1,))
    assert bound[0] is params and bound[1] is store
    store_ids = {id(x) for x in store.values()}
    param_ids = {id(x) for x in S.flatten(params)[0]}
    assert len(bufs) == 3
    for buf, src, arg in zip(bufs, args[2:], bound[2:]):
        assert buf is arg and buf is not src
        assert buf.data_ptr() != src.data_ptr() and torch.equal(buf, src)
        assert id(buf) not in store_ids | param_ids
    copied = S.copied_leaves(args, (1,))
    assert [id(x) for x in copied] == [id(x) for x in args[2:]]
    # without donation the store is copied in like any argument
    assert len(S.bind_inputs(args, ())[1]) == 3 + len(store)


def test_outputs_are_fresh_except_the_donated_store(small):
    cfg, params = small
    store = _store(cfg)
    args = (params, store, *_decode_args(cfg))
    bound, _ = S.bind_inputs(args, (1,))
    static = S.make_decode_step(cfg, paged=True)(*bound)
    plan = S.output_plan(static, bound, (1,))
    assert plan[0] == "tuple" and plan[1][2] == ("arg", 1)
    out = S.materialize(plan, args)
    assert out[2] is store
    for got, cap in zip(out[:2], static[:2]):
        assert got is not cap and got.data_ptr() != cap.data_ptr()
        assert torch.equal(got, cap)
    # a leaf of the store returned alone comes back as the caller's leaf
    plan = S.output_plan((store["k"], 3), bound, (1,))
    assert plan == ("tuple", [("leaf", 1, 0), ("const", 3)])
    assert S.materialize(plan, args)[0] is store["k"]


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------


def test_recording_diverts_only_this_thread():
    c = K.COUNTERS["paged_attention"]
    K.reset_launch_counts()
    with _build.recording_launches() as rec:
        c.add()
        c.add(2)
        t = threading.Thread(target=c.add)      # another thread counts
        t.start()
        t.join()
        with _build.recording_launches() as inner:
            c.add()
        assert inner == {"paged_attention": 1}
    assert rec == {"paged_attention": 3}
    assert c.value == 1
    c.add()
    assert c.value == 2
    S.add_launches({"paged_attention": 5, "paged_chunk_attention": 2})
    assert K.launch_counts()["paged_attention"] == 7
    assert K.launch_counts()["paged_chunk_attention"] == 2
    K.reset_launch_counts()


def _counting_step(w, store, x):
    """A step that 'launches' K5 twice and K6 once a call."""
    K.COUNTERS["paged_attention"].add()
    K.COUNTERS["paged_attention"].add()
    K.COUNTERS["paged_chunk_attention"].add()
    store["acc"] += x.sum()
    return x * w, store


def test_a_replay_adds_the_captured_launches_and_the_capture_none(
        fake_graphs):
    step = S.jit_step(_counting_step, donate_argnums=(1,))
    w, store = torch.tensor(2.0), {"acc": torch.zeros(())}
    x = torch.arange(4.0)
    K.reset_launch_counts()
    y, st = step(w, store, x)            # the eager warm-up
    assert st is store and torch.equal(y, x * 2)
    assert (step.stats.warmups, step.stats.captures) == (1, 0)
    # the warm-up's launches ran on the device and count
    assert K.launch_counts()["paged_attention"] == 2
    assert K.launch_counts()["paged_chunk_attention"] == 1
    assert float(store["acc"]) == 6.0
    for n in range(1, 4):                # a capture and replay, 2 replays
        y, st = step(w, store, x + n)
        assert st is store and torch.equal(y, (x + n) * 2)
        # the capture recorded its launches without counting them; each
        # replay adds them once
        assert K.launch_counts()["paged_attention"] == 2 + 2 * n
        assert K.launch_counts()["paged_chunk_attention"] == 1 + n
    assert step._captured.launches == {"paged_attention": 2,
                                       "paged_chunk_attention": 1}
    assert step.stats.captures == 1 and step.stats.capture_at == [2]
    assert step.stats.replays == 3 and step.stats.warmups == 1
    assert float(store["acc"]) == 6.0 + 10 + 14 + 18   # one run a call
    K.reset_launch_counts()


def test_a_key_seen_once_is_never_captured(fake_graphs):
    """Calls whose key changes every time (a new parameter tree each)
    run eagerly, each once, and capture nothing."""
    step = S.jit_step(_counting_step, donate_argnums=(1,))
    store = {"acc": torch.zeros(())}
    for i in range(3):
        y, _ = step(torch.tensor(float(i)), store, torch.ones(2))
        assert torch.equal(y, torch.full((2,), float(i)))
    assert (step.stats.warmups, step.stats.captures,
            step.stats.replays) == (3, 0, 0)
    assert float(store["acc"]) == 6.0
    K.reset_launch_counts()


# ---------------------------------------------------------------------------
# The capture-and-replay flow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_graphed_decode_equals_eager_and_recaptures_on_a_swap(
        small, fake_graphs, quant):
    """Ticks through the graph equal the eager ticks (tokens, logits and
    the store), a copied argument read afresh each call; a new parameter
    tree (a hot swap) drops the graph, which lets the old tree go, and
    captures once more."""
    cfg, params = small
    bare = S.make_decode_step(cfg, paged=True)
    graphed = S.jit_step(S.make_decode_step(cfg, paged=True),
                         donate_argnums=(1,))
    s_eager, s_graph = _store(cfg, quant), _store(cfg, quant)
    old = _clone_tree(params)
    old_ref = weakref.ref(old["embed"])
    tok, clen, pages = _decode_args(cfg)
    for i in range(6):
        p = old if i < 3 else params
        want = bare(p, s_eager, tok, clen, pages)
        got = graphed(p, s_graph, tok, clen, pages)
        assert got[2] is s_graph
        _equal_trees(list(want[:2]), list(got[:2]))
        _equal_trees(s_eager, s_graph)
        tok, clen = want[0], clen + (clen > 0).int()
        if i == 2:
            del old, p
    # per tree: a warm-up, a capture that replays, a replay
    st = graphed.stats
    assert (st.warmups, st.captures, st.replays) == (2, 2, 4)
    assert st.warmup_at == [1, 4] and st.capture_at == [2, 5]
    assert len(st.capture_ms) == 2
    assert graphed._captured.args[0] is params
    assert old_ref() is None             # the first graph let it go
    graphed.reset()
    assert graphed._captured is None


def test_a_capture_error_raises_and_holds_no_graph(small, monkeypatch):
    monkeypatch.setattr(S, "step_device", lambda args: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    def broken(fn, args):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(S, "capture_graph", broken)
    step = S.jit_step(_counting_step, donate_argnums=(1,))
    w, store = torch.tensor(2.0), {"acc": torch.zeros(())}
    step(w, store, torch.ones(2))        # the warm-up
    with pytest.raises(RuntimeError, match="capture failed"):
        step(w, store, torch.ones(2))
    assert step._captured is None and step.stats.captures == 0
    assert float(store["acc"]) == 2.0    # the failed call ran nothing
    monkeypatch.setattr(S, "capture_graph", fake_capture)
    for _ in range(2):                   # a warm-up again, then a capture
        step(w, store, torch.ones(2))
    assert step.stats.captures == 1 and step.stats.replays == 1
    K.reset_launch_counts()


# ---------------------------------------------------------------------------
# The engine on the graphed steps, against repro's
# ---------------------------------------------------------------------------


def test_scheduler_engine_steps_are_graphed(small):
    cfg, params = small
    sc = TE.SchedulerConfig(max_slots=2, page_size=4, max_seq=32,
                            prefill_chunk=4)
    eng = TE.ServingEngine(cfg, params, n_pages=8, scheduler=sc,
                           device="cpu")
    for step in (eng._decode_paged, eng._prefill_paged):
        assert isinstance(step, S.GraphedStep)
        assert step.donate_argnums == (1,)


def test_graphed_scheduler_engine_matches_jax_engine_bf16(
        models, monkeypatch, fake_graphs):
    """``test_torch_scheduler.py``'s prefix-cache trace (a warm request,
    its repeat riding shared pages, a prompt diverging inside a page)."""
    jeng, teng, want, got, n_pages = SCENARIOS["prefix_cow"](models,
                                                            monkeypatch)
    assert got == want
    dec, pre = teng._decode_paged, teng._prefill_paged
    assert dec.stats.captures == 1 and dec.stats.replays >= 1
    assert pre.stats.captures == 1 and pre.stats.replays >= 1
    for eng in (jeng, teng):
        _drained(eng, n_pages)
    assert teng.scheduler.stats() == jeng.scheduler.stats()


def test_graphed_scheduler_engine_matches_jax_engine_int8(
        models, monkeypatch, fake_graphs):
    """``test_torch_quant_kv.py``'s COW trace on the int8 store."""
    jeng, teng = QKV._engines(models, monkeypatch)
    prompts = [QKV.BASE, QKV.BASE, QKV.DIV]
    want = QKV._serve(jeng, QKV.JE, prompts, 4, warm=1)
    got = QKV._serve(teng, TE, prompts, 4, warm=1)
    assert got == want
    dec = teng._decode_paged
    assert dec.stats.captures == 1 and dec.stats.replays >= 1
    # as the eager engine's test holds them: the scales within 1e-6
    # relative (float32 rounding between the frameworks), the int8 bytes
    # exact on this trace
    for k in ("k_scale", "v_scale"):
        np.testing.assert_allclose(teng._pages_kv[k].numpy(),
                                   np.asarray(jeng._pages_kv[k]), rtol=1e-6,
                                   atol=0)
    for k in ("k", "v"):
        np.testing.assert_array_equal(teng._pages_kv[k].numpy(),
                                      np.asarray(jeng._pages_kv[k]))
    _drained(teng, 64)
