"""The port's ServingEngine (handler mode, on the CPU through the kernels'
plain versions) against ``repro``'s: identical tokens for the same
requests, and the end-to-end checks of tests/test_engine.py under weight
hot-swap and compaction."""

import dataclasses
import itertools

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


def _run(eng, reqs, timeout=600):
    for r in reqs:
        eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=timeout), "request timed out"
    eng.stop()


def _requests(mod, vocab):
    rng = np.random.default_rng(3)
    return [mod.Request(rid=i, prompt=rng.integers(1, vocab, 6)
                        .astype(np.int32), max_new=4) for i in range(3)]


@pytest.mark.parametrize("lock_name", ["bravo-ba", "ba"])
def test_engine_tokens_match_jax_engine(lock_name):
    """One request per batch, no swap: the same requests give identical
    tokens through both engines (float32 compute on both sides; the caches
    are bf16 in both)."""
    cj = dataclasses.replace(JC.get_smoke("llama3.2-1b"),
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke("llama3.2-1b"),
                             compute_dtype=torch.float32)
    jp = JM.init_params(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jeng = JE.ServingEngine(cj, jp, mesh=mesh, rules=MeshRules(),
                            lock_name=lock_name, handlers=1, max_seq=32,
                            slots_per_handler=1)
    teng = TE.ServingEngine(ct, tp, lock_name=lock_name, handlers=1,
                            max_seq=32, slots_per_handler=1, device="cpu")
    jreqs, treqs = _requests(JE, cj.vocab), _requests(TE, ct.vocab)
    jeng.start()
    _run(jeng, jreqs)
    teng.start()
    _run(teng, treqs)
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.out, jr.out)
    tst, jst = teng.lock_stats()["engine"], jeng.lock_stats()["engine"]
    assert tst == {k: jst[k] for k in tst}


@pytest.mark.parametrize("lock_name", ["bravo-ba", "ba"])
def test_engine_end_to_end_under_swap_and_compaction(lock_name):
    cfg = TC.get_smoke("llama3.2-1b")
    params = TM.init_params(0, cfg, device="cpu")
    eng = TE.ServingEngine(cfg, params, lock_name=lock_name, handlers=2,
                           max_seq=32, slots_per_handler=2, device="cpu")
    eng.start(swap_period_s=0.05, compact_period_s=0.07)
    reqs = [TE.Request(rid=i, prompt=np.arange(1, 6, dtype=np.int32),
                       max_new=3) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=600), "request timed out"
        assert r.out is not None and len(r.out) == 3
        assert all(0 <= t < cfg.vocab for t in r.out)
    # keep serving until the updater has landed a swap
    extra = TE.Request(rid=99, prompt=np.arange(1, 6, dtype=np.int32),
                       max_new=3)
    while eng.stats.weight_swaps < 1:
        eng.submit(extra)
        assert extra.done.wait(timeout=600)
        extra = TE.Request(rid=99, prompt=extra.prompt, max_new=3)
    eng.stop()
    st = eng.lock_stats()
    assert st["engine"]["decode_steps"] > 0
    assert st["engine"]["weight_swaps"] >= 1
    assert st["engine"]["compactions"] >= 0
    if lock_name.startswith("bravo"):
        ms = st["model"]
        assert ms["fast_acquires"] > 0 or ms["revocations"] > 0 \
            or ms["bias_sets"] > 0, ms
    assert st["device_leases"]["revocations"] >= 1
    assert len(eng.pages.free) == 4096
    locks = [eng.store.leases] + eng.kv_pool.locks
    np.testing.assert_array_equal(eng.registry.held_multi(locks),
                                  np.zeros(len(locks)))


def test_scheduler_mode_is_not_ported_yet():
    """Scheduler mode is ported (tests/test_torch_scheduler.py), the
    quantized page store with it (tests/test_torch_quant_kv.py), and now
    the latency-feedback controller too: the engine builds with a
    ``ControllerConfig``, and ``_ctrl_tick`` reads the windowed sensors and
    sets the scheduler's limits and the gauges
    (tests/test_torch_controller.py holds it against ``repro``'s)."""
    from repro_torch.serving.scheduler import (ControllerConfig,
                                               SchedulerConfig)
    cfg = TC.get_smoke("llama3.2-1b")
    params = TM.init_params(0, cfg, device="cpu")
    eng = TE.ServingEngine(cfg, params, device="cpu", n_pages=64,
                           scheduler=SchedulerConfig(
                               max_slots=8, controller=ControllerConfig(
                                   step_p99_target_ms=1.0, min_samples=2,
                                   watermark_step=0.1)))
    slot_cap = eng.metrics.gauge("sched.slot_cap")
    free_frac = eng.metrics.gauge("sched.admit_free_frac")
    assert (slot_cap.value, free_frac.value) == (8, 0.0)
    for _ in range(3):
        eng._w_step.observe(5e6)            # 5 ms, over the 1 ms target
    eng._ctrl_tick()
    assert eng.scheduler.slot_cap == slot_cap.value == 4
    assert eng.scheduler.admit_free_frac == free_frac.value == 0.1
    eng._ctrl_tick()                        # paced: within the period
    assert slot_cap.value == 4


def _stores(kind, monkeypatch):
    """``repro``'s and the port's ModelStore over the same kind of lease:
    a plain single-lock ``LeaseHandle`` (lock id 31 on both sides), a
    registry lock (both registries' lock ids from one base), or none.
    -> ((jax store, its table), (port store, its table)), each table a
    callable."""
    from repro.core import device_bravo as JDB
    from repro.core import registry as JR
    from repro.core.atomics import LiveMem as JLiveMem
    from repro.core.factory import LockEnv as JLockEnv
    from repro_torch.core import device_bravo as TDB
    from repro_torch.core import registry as TR
    from repro_torch.core.atomics import LiveMem as TLiveMem
    from repro_torch.core.factory import LockEnv as TLockEnv

    if kind == "lease_handle":
        jt, tt = JDB.DeviceLeaseTable(), TDB.DeviceLeaseTable(device="cpu")
        jl, tl = jt.handle(lock_id=31), tt.handle(lock_id=31)
        jtab, ttab = (lambda: jt.state.table), (lambda: tt.state.table)
    elif kind == "registry":
        monkeypatch.setattr(JR, "next_lock_id", itertools.count(500).__next__)
        monkeypatch.setattr(TR, "next_lock_id", itertools.count(500).__next__)
        jr, tr = JR.BravoRegistry(), TR.BravoRegistry(device="cpu")
        jl, tl = jr.alloc(name="model"), tr.alloc(name="model")
        jtab, ttab = (lambda: jr.table), (lambda: tr.table)
    else:
        jl = tl = jtab = ttab = None
    js = JE.ModelStore({"w": 0}, JLockEnv(JLiveMem()).make("bravo-ba"),
                       leases=jl)
    ts = TE.ModelStore({"w": 0}, TLockEnv(TLiveMem()).make("bravo-ba"),
                       leases=tl)
    return (js, jtab), (ts, ttab)


@pytest.mark.parametrize("kind", ["lease_handle", "registry", "none"])
def test_model_store_over_either_lease_protocol(kind, monkeypatch):
    """``ModelStore`` takes a plain ``LeaseHandle`` (no ``gen``), a
    registry lock or no lease at all, as ``repro``'s does: the same
    batch reads (with a duplicate reader, which is denied) leave the same
    table as ``repro``'s store, and the swap drains and bumps the epoch."""
    (js, jtab), (ts, ttab) = _stores(kind, monkeypatch)

    def same():
        if jtab is not None:
            np.testing.assert_array_equal(np.asarray(jtab()),
                                          ttab().numpy())

    rids = [3, 4, 5, 3]
    jtok, jp, je = js.read_batch(jnp.asarray(rids, jnp.int32))
    ttok, tp, te = ts.read_batch(torch.tensor(rids, dtype=torch.int32))
    assert (tp, te) == (jp, je) == ({"w": 0}, 0)
    same()
    if kind == "none":
        assert ttok[1] is None and ttok[2] is None
    else:
        np.testing.assert_array_equal(np.asarray(jtok[1]), ttok[1].numpy())
        assert ttok[1].tolist() == [True, True, True, False]
        assert ttok[2] == (0 if kind == "registry" else None)
        assert ttab().any()
    js.done_read_batch(jtok, jnp.asarray(rids, jnp.int32))
    ts.done_read_batch(ttok, torch.tensor(rids, dtype=torch.int32))
    same()
    tok, params, epoch = ts.read()           # the host lock alone
    assert (params, epoch) == ({"w": 0}, 0)
    ts.done_read(tok)
    js.swap({"w": 1}, max_wait_s=5.0)
    ts.swap({"w": 1}, max_wait_s=5.0)
    same()
    assert (ts.params, ts.epoch) == (js.params, js.epoch) == ({"w": 1}, 1)
    if ttab is not None:
        assert not ttab().any()              # drained
