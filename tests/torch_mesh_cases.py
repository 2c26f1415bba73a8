"""Shared machinery of the mesh tests (tests/test_torch_mesh_*.py).

The port's side runs in ranks of a gloo world, spawned here
(:func:`run_ranks`): each rank sets one thread, starts its rank from a
``file://`` store in a fresh temporary directory (so parallel test workers
never share a port), runs one of the ``rank_*`` functions below and saves
what it returns; the spawn is joined with a deadline, so a hung rank fails
its test instead of stalling the suite.  The functions import neither JAX
nor ``repro``, which keeps each rank's start-up to PyTorch's.

``repro``'s side runs in one subprocess a test file (:func:`jax_oracle`),
with ``--xla_force_host_platform_device_count=8`` set before JAX is
imported, as tests/test_sharding.py does: rank ``r`` of a port mesh and
device ``r`` of the JAX mesh of the same shape sit at the same
coordinates (both lay ranks out row-major).
"""

import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np
import torch
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
RANKS_TIMEOUT_S = 240.0
ORACLE_TIMEOUT_S = 600.0

# (mesh shape, axis names) of each gloo world the collectives run on
MESHES = {2: ((2,), ("data",)),
          4: ((2, 2), ("pod", "data")),
          8: ((2, 2, 2), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# Spawning ranks and the JAX oracle
# ---------------------------------------------------------------------------


def _rank_main(rank, world, store_dir, fn_name, args, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, SRC)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world

    init_world(store_dir, rank, world, device="cpu", timeout_s=120.0)
    try:
        res = globals()[fn_name](rank, world, *args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn_name, world, *args, timeout=RANKS_TIMEOUT_S):
    """``fn_name(rank, world, *args)`` on every rank of a new gloo world
    of ``world``; -> the ranks' results, in rank order.  A rank that
    raises fails the call with its traceback; one that outlives
    ``timeout`` is killed and the call raises ``TimeoutError``."""
    with tempfile.TemporaryDirectory() as d:
        _spawn(_rank_main, world, (world, os.path.join(d, "store"), fn_name,
                                   args, d), timeout, fn_name)
        out = []
        for r in range(world):
            with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _spawn(fn, world, args, timeout, what):
    """``fn(rank, *args)`` in ``world`` spawned processes, joined with a
    deadline; a process still running past it is killed."""
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{what} on {world} ranks: no end after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def jax_oracle(code: str, inputs=None, timeout=ORACLE_TIMEOUT_S):
    """Run ``code`` in a fresh interpreter with 8 fake XLA host devices,
    ``INPUTS`` bound to ``inputs``; the code leaves its answers in the
    dict ``OUT``.  -> ``OUT``."""
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.pkl"), os.path.join(d, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(inputs, f)
        prog = textwrap.dedent(f"""
            import os, pickle, sys
            os.environ["XLA_FLAGS"] = \
                "--xla_force_host_platform_device_count=8"
            os.environ["JAX_PLATFORMS"] = "cpu"
            sys.path.insert(0, {SRC!r})
            INPUTS = pickle.load(open({src!r}, "rb"))
            OUT = {{}}
        """) + textwrap.dedent(code) + textwrap.dedent(f"""
            pickle.dump(OUT, open({dst!r}, "wb"))
        """)
        res = subprocess.run([sys.executable, "-c", prog],
                             capture_output=True, text=True, timeout=timeout)
        assert res.returncode == 0, res.stderr[-4000:]
        with open(dst, "rb") as f:
            return pickle.load(f)


# ---------------------------------------------------------------------------
# Inputs, the same on both sides
# ---------------------------------------------------------------------------


def revoke_table():
    """``repro``'s benchmark table (seed 9): 37 slots hold 77; plus 50
    slots of 5, so two values share the table."""
    rng = np.random.default_rng(9)
    table = np.zeros((32, 128), np.int32)
    hits = rng.choice(4096, 37, replace=False)
    table.reshape(-1)[hits] = 77
    free = np.flatnonzero(table.reshape(-1) == 0)
    table.reshape(-1)[rng.choice(free, 50, replace=False)] = 5
    return table


REVOKE_LOCKS = (77, 5, 9)                       # 9 publishes nowhere
SHARDED_LOCKS = ((0, 77), (37, 5), (127, 9), (70, 77))   # (lane, value)


def rbias0():
    return (np.random.default_rng(1).random(128) < 0.7).astype(np.int32)


def grads(seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(3, 5)).astype(np.float32),
             (1e-3 * rng.normal(size=(3, 5))).astype(np.float32)),
            (rng.normal(size=(64,)).astype(np.float32) * 40,
             np.zeros((64,), np.float32))]


def smoke_f32(arch):
    """The port's smoke config of ``arch`` in float32 throughout."""
    import dataclasses

    from repro_torch import configs as TC
    return dataclasses.replace(TC.get_smoke(arch), param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def revoke_axes(names):
    """The axis choices of the revokes on a mesh: each data axis alone
    and, where there are two, both outermost-first."""
    data = tuple(a for a in ("pod", "data") if a in names)
    out = [("data",)]
    if len(data) > 1:
        out.append(data)
    return out


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------


def _mesh(world):
    from repro_torch.launch.mesh import make_mesh
    shape, names = MESHES[world]
    return make_mesh(shape, names, device="cpu"), names


def rank_collectives(rank, world, params_np):
    """The revokes, the compressed all-reduce, the registry on a mesh and
    ``reshard_tree`` on this world's mesh."""
    from repro_torch.core import device_bravo as DB
    from repro_torch.core import registry as RG
    from repro_torch.core.errors import ProtocolError
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.ft.compression import (compress_grads_int8,
                                            make_compressed_psum)
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.launch import specs as LS

    mesh, names = _mesh(world)
    out = {"coords": {a: int(mesh.get_local_rank(a)) for a in names}}
    table = torch.from_numpy(revoke_table())
    for axes in revoke_axes(names):
        rev = DB.make_distributed_revoke(
            mesh, axis=axes[0] if len(axes) == 1 else axes)
        out[("distributed", axes)] = [int(rev(table, lid))
                                      for lid in REVOKE_LOCKS]
        sharded = RG.make_sharded_revoke(mesh, axes)
        rb = torch.from_numpy(rbias0())
        steps = []
        for idx, lid in SHARDED_LOCKS:
            h = type("H", (), {"idx": idx, "lock_id": lid})()
            rb, cnt = sharded(table, rb, h)
            steps.append((rb.numpy().copy(), int(cnt)))
        out[("sharded", axes)] = steps
    # the registry's configure_mesh: a lane count the shards do not divide
    # is refused; a divisible one revokes through the collective
    data = tuple(a for a in ("pod", "data") if a in names)
    try:
        RG.BravoRegistry(max_locks=5, device="cpu").configure_mesh(mesh, data)
        out["refused"] = None
    except ProtocolError as e:
        out["refused"] = type(e).__name__
    reg = RG.BravoRegistry(device="cpu")
    reg.configure_mesh(mesh, data)
    hs = [reg.alloc(f"l{i}") for i in range(3)]
    ids = torch.arange(8, dtype=torch.int32)
    granted = hs[1].acquire(ids)
    hs[1].release(ids, granted)
    out["registry"] = {"scans": hs[1].revoke(),
                       "rbias": reg.rbias.numpy().copy(),
                       "held": hs[1].held()}
    reg.configure_mesh(None)
    out["registry"]["unmeshed_scans"] = hs[2].revoke()
    # the compressed all-reduce: the same leaf on every rank (repro's
    # replicated input), then a rank's own leaf against numpy
    psum_fn = make_compressed_psum(mesh, data)
    out["compressed"] = []
    for g, err in grads():
        mean, new_err = psum_fn(torch.from_numpy(g), torch.from_numpy(err))
        out["compressed"].append((mean.numpy(), new_err.numpy()))
    g_r = torch.from_numpy(grads(seed=10 + rank)[0][0])
    mean, new_err = psum_fn(g_r, torch.zeros_like(g_r))
    q, scale, _ = compress_grads_int8(g_r)
    out["own_leaf"] = (mean.numpy(), new_err.numpy(), q.numpy(),
                       float(scale))
    # reshard_tree: this rank's block of each leaf
    like = LS.params_shape(smoke_f32("llama3.2-1b"))
    out["reshard"] = {}
    for decode in (False, True):
        placed = reshard_tree(params_np, like, MeshRules(), mesh,
                              decode=decode, device="cpu")
        out["reshard"][decode] = _flat(placed)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree.detach().numpy().copy()}


# ---------------------------------------------------------------------------
# MoE bodies and paged wrappers (tests/test_torch_mesh_moe.py)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b")
MOE_MESHES = {"2x2": ((2, 2), ("data", "model")),
              "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}
# (name, decode_tp, weight_resident, split_tokens_over_model): repro's three
# shard_map layouts, as its MoE stack picks them for training/prefill (the
# split capacity bodies) and decode
MOE_BODIES = (("capacity", False, False, True),
              ("resident", False, True, True),
              ("decode_tp", True, False, False))


def moe_inputs(d_model, seed=0):
    """Two (4, 8, d) batches: random tokens, and every token identical
    (its experts overflow their capacity on every shard)."""
    rng = np.random.default_rng(seed)
    rand = rng.normal(size=(4, 8, d_model)).astype(np.float32)
    same = np.broadcast_to(rng.normal(size=d_model),
                           (4, 8, d_model)).astype(np.float32)
    return {"random": rand, "same": same}


def paged_inputs(seed=0, b=4, s=3, h=4, kvh=2, hd=16, ps=4, lanes=5,
                 n_pages=24):
    """A data-sharded batch for the four paged wrappers: float32 and int8
    pages with per-page scales, rows of 1-5 pages, one row empty."""
    rng = np.random.default_rng(seed)
    q1 = rng.normal(size=(b, h, hd)).astype(np.float32)
    qs = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    kq = rng.integers(-127, 128, (n_pages, ps, kvh, hd)).astype(np.int8)
    vq = rng.integers(-127, 128, (n_pages, ps, kvh, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 0.05, (n_pages, kvh)).astype(np.float32)
    vs = rng.uniform(1e-3, 0.05, (n_pages, kvh)).astype(np.float32)
    pages = np.full((b, lanes), -1, np.int32)
    clen = np.zeros((b,), np.int32)
    nlen = np.zeros((b,), np.int32)
    perm = rng.permutation(n_pages)
    for i in range(b - 1):
        nl = int(rng.integers(1, s + 1))
        c = int(rng.integers(nl, lanes * ps + 1))
        npg = -(-c // ps)
        pages[i, :npg] = perm[i * lanes:i * lanes + npg]
        clen[i], nlen[i] = c, nl
    return dict(q1=q1, qs=qs, kp=kp, vp=vp, kq=kq, vq=vq, ks=ks, vs=vs,
                pages=pages, clen=clen, nlen=nlen)


def rank_moe(rank, world, params, paged):
    """The three MoE bodies through ``moe_forward`` on each mesh, and the
    four paged wrappers on the (2, 2) mesh."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TT

    out, meshes = {}, {}
    for name, (shape, names) in MOE_MESHES.items():
        meshes[name] = make_mesh(shape, names, device="cpu")
    for arch in MOE_ARCHS:
        cfg = smoke_f32(arch)
        p = _tensors(params[arch])
        for name, mesh in meshes.items():
            data_axes = tuple(a for a in ("pod", "data")
                              if a in mesh.mesh_dim_names)
            for body, decode_tp, resident, split in MOE_BODIES:
                for kind, x in moe_inputs(cfg.d_model).items():
                    y, aux = TT.moe_forward(
                        p, torch.from_numpy(x), cfg, meshes[name], data_axes,
                        split, decode_tp=decode_tp, weight_resident=resident)
                    out[(arch, name, body, kind)] = (y.numpy(), float(aux))
    t = _tensors(paged)
    mesh, axes = meshes["2x2"], ("data",)
    out["paged"] = TT._paged_attention_sharded(
        t["q1"], t["kp"], t["vp"], t["pages"], t["clen"], mesh, axes).numpy()
    out["chunk"] = TT._paged_chunk_attention(
        t["qs"], t["kp"], t["vp"], t["pages"], t["clen"], t["nlen"], mesh,
        axes).numpy()
    out["paged_quant"] = TT._paged_attention_quant_sharded(
        t["q1"], t["kq"], t["vq"], t["ks"], t["vs"], t["pages"], t["clen"],
        mesh, axes).numpy()
    out["chunk_quant"] = TT._paged_chunk_attention_quant(
        t["qs"], t["kq"], t["vq"], t["ks"], t["vs"], t["pages"], t["clen"],
        t["nlen"], mesh, axes).numpy()
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# The meshed engine and train step (tests/test_torch_mesh_engine.py)
# ---------------------------------------------------------------------------

ENGINE_SCHED = dict(max_slots=4, page_size=8, max_seq=64, prefill_chunk=8,
                    prefill_rows=2, token_budget=16)
ENGINE_TOKENS = 8
TRAIN_MESH = ((4, 2), ("data", "model"))
TRAIN_B, TRAIN_S, TRAIN_MICRO = 8, 32, 2
# tests/test_torch_train_b.py's optimizer for update parity: the full
# rate at step 1, where R14's bound on an update is stated
TRAIN_OPT = dict(lr=1e-3, warmup_steps=0)


def engine_trace():
    """Six prompts of 3-14 tokens, two sharing a 8-token prefix: more
    requests than slots, so admission queues."""
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 500, 8).astype(np.int32)
    out = [rng.integers(1, 500, n).astype(np.int32) for n in (3, 14, 6, 9)]
    out += [np.concatenate([shared, rng.integers(1, 500, 3)]).astype(
        np.int32) for _ in range(2)]
    return out


def train_batches():
    """The step's batch, without and with a random 0/1 mask over the
    labels (each shard then holds its own count of labelled positions)."""
    rng = np.random.default_rng(7)
    b = {"tokens": rng.integers(0, 512, (TRAIN_B, TRAIN_S)).astype(np.int32),
         "labels": rng.integers(0, 512, (TRAIN_B, TRAIN_S)).astype(np.int32)}
    mask = (rng.random((TRAIN_B, TRAIN_S)) < 0.5).astype(np.float32)
    mask[:TRAIN_B // 4] = 0.0       # one rank's rows: no label at all
    mask[TRAIN_B // 4, :3] = 1.0
    return {"plain": b, "masked": {**b, "mask": mask}}


def rank_engine(rank, world, params_np):
    """The scheduler twin's ``mesh2d`` at (2, 2, 2), the meshed scheduler
    engine on :func:`engine_trace`, and one meshed train step on the
    (4, 2) mesh."""
    from repro_torch.benchmarks import scheduler as SB
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_step as TT

    cfg = smoke_f32("llama3.2-1b")
    params = TM.from_jax_params(params_np, cfg, device="cpu")
    out = {"mesh2d": SB.bench_mesh2d(cfg, params, "cpu", False,
                                     ENGINE_TOKENS),
           "failures": list(SB.FAILURES)}
    mesh = SB.mesh2d(False, "cpu")
    eng = ServingEngine(cfg, params, n_pages=128, device="cpu", mesh=mesh,
                        rules=MeshRules(),
                        scheduler=SchedulerConfig(**ENGINE_SCHED))
    reqs = [Request(rid=i, prompt=p, max_new=ENGINE_TOKENS)
            for i, p in enumerate(engine_trace())]
    eng.start()
    for r in reqs:
        eng.submit(r)
    assert all(r.done.wait(timeout=120) for r in reqs)
    eng.stop()
    out["trace"] = [list(map(int, r.out)) for r in reqs]
    out["free_after"] = eng.kv_pool.free_count()

    shape, names = TRAIN_MESH
    tmesh = make_mesh(shape, names, device="cpu")
    opt = TO.OptimizerConfig(**TRAIN_OPT)
    state = TO.adamw_init(params, opt)
    step = TT.make_train_step(cfg, opt, tmesh, MeshRules(),
                              tcfg=TT.TrainConfig(remat="full",
                                                  microbatches=TRAIN_MICRO))
    out["train"] = {}
    for kind, batch in train_batches().items():
        p1, s1, m = step(params, state, batch)
        out["train"][kind] = {"loss": float(m["loss"]),
                              "grad_norm": float(m["grad_norm"]),
                              "params": _flat(p1), "m": _flat(s1["m"])}
    return out
