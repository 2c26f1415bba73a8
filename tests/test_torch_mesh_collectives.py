"""The port's collectives over a mesh against ``repro`` on fake devices.

Gloo worlds of 2, 4 and 8 ranks run the meshes ``("data",)``, ``("pod",
"data")`` and ``("pod", "data", "model")``
(``torch_mesh_cases.MESHES``); ``repro`` runs the same shapes on 8 fake
XLA host devices in one subprocess.  Checked, rank by rank against the
device at the same coordinates:

* ``make_distributed_revoke`` (each data axis alone and both) and
  ``make_sharded_revoke`` (four locks in a row, the rbias vector carried
  from one to the next): counts and rbias exactly;
* ``BravoRegistry.configure_mesh``: ``ProtocolError`` when the shards do
  not divide the lanes, as ``repro``'s; a meshed revoke drains and clears
  its lane on every rank; ``configure_mesh(None)`` revokes as before;
* ``make_compressed_psum``: the mean and the new error within 1e-6 of
  ``repro``'s (the int8 payload sums exactly; the two float products
  round alike), and a rank's own leaf against numpy's mean of the ranks'
  quantized leaves;
* ``reshard_tree`` (training and decode layouts): each rank's block of
  every leaf equals the addressable shard JAX places on the device at the
  same coordinates, exactly.
"""

import numpy as np
import pytest

import torch_mesh_cases as C

REL = 1e-6
WORLDS = sorted(C.MESHES)

ORACLE = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.core import device_bravo as DB
from repro.core import registry as RG
from repro.core.errors import ProtocolError
from repro.dist.sharding import MeshRules
from repro.ft.compression import make_compressed_psum
from repro.ft.elastic import reshard_tree
from repro.models import model as JM

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}

devs = np.array(jax.devices())
table = jnp.asarray(INPUTS["table"])
cfg = dataclasses.replace(configs.get_smoke("llama3.2-1b"),
                          compute_dtype=jnp.float32)
params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg))
pshape = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
OUT["params"] = params
for world, (shape, names) in INPUTS["meshes"].items():
    mesh = Mesh(devs[:world].reshape(shape), names)
    data = tuple(a for a in ("pod", "data") if a in names)
    res = {}
    with mesh:
        for axes in INPUTS["revoke_axes"][world]:
            rev = DB.make_distributed_revoke(
                mesh, axis=axes[0] if len(axes) == 1 else axes)
            res[("distributed", axes)] = [int(rev(table, lid))
                                          for lid in INPUTS["locks"]]
            sharded = RG.make_sharded_revoke(mesh, axes)
            rb = jnp.asarray(INPUTS["rbias0"])
            steps = []
            for idx, lid in INPUTS["sharded_locks"]:
                h = type("H", (), {"idx": idx, "lock_id": lid})()
                rb, cnt = sharded(table, rb, h)
                steps.append((np.asarray(rb), int(cnt)))
            res[("sharded", axes)] = steps
        try:
            RG.BravoRegistry(max_locks=5).configure_mesh(mesh, data)
            res["refused"] = None
        except ProtocolError as e:
            res["refused"] = type(e).__name__
        reg = RG.BravoRegistry()
        reg.configure_mesh(mesh, data)
        hs = [reg.alloc(f"l{i}") for i in range(3)]
        ids = jnp.arange(8, dtype=jnp.int32)
        granted = hs[1].acquire(ids)
        hs[1].release(ids, granted)
        hs[1].revoke()
        res["registry"] = {"rbias": np.asarray(reg.rbias),
                           "held": hs[1].held()}
        fn = make_compressed_psum(mesh, data)
        res["compressed"] = []
        for g, err in INPUTS["grads"]:
            mean, new_err = fn(jnp.asarray(g), jnp.asarray(err))
            res["compressed"].append((np.asarray(mean), np.asarray(new_err)))
        res["reshard"] = {}
        for decode in (False, True):
            placed = flat(reshard_tree(params, pshape, MeshRules(), mesh,
                                       decode=decode))
            res["reshard"][decode] = {
                path: {s.device.id: np.asarray(s.data)
                       for s in leaf.addressable_shards}
                for path, leaf in placed.items()}
    OUT[world] = res
"""


@pytest.fixture(scope="module")
def oracle():
    return C.jax_oracle(ORACLE, {
        "table": C.revoke_table(), "locks": C.REVOKE_LOCKS,
        "sharded_locks": C.SHARDED_LOCKS, "rbias0": C.rbias0(),
        "grads": C.grads(), "meshes": C.MESHES,
        "revoke_axes": {w: C.revoke_axes(n) for w, (_, n) in
                        C.MESHES.items()}})


@pytest.fixture(scope="module")
def ranks(oracle):
    return {w: C.run_ranks("rank_collectives", w, oracle["params"])
            for w in WORLDS}


def _axes(world):
    return C.revoke_axes(C.MESHES[world][1])


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_revoke_counts_match_repro(world, oracle, ranks):
    for axes in _axes(world):
        want = oracle[world][("distributed", axes)]
        assert want == [37, 50, 0]
        for r in ranks[world]:
            assert r[("distributed", axes)] == want, axes


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_revoke_counts_and_rbias_match_repro(world, oracle, ranks):
    for axes in _axes(world):
        want = oracle[world][("sharded", axes)]
        for r in ranks[world]:
            got = r[("sharded", axes)]
            assert [c for _, c in got] == [c for _, c in want] \
                == [37, 50, 0, 37]
            for (grb, _), (wrb, _) in zip(got, want):
                np.testing.assert_array_equal(grb, wrb)
        # each lock's lane is cleared, every other lane as it was
        rb = C.rbias0()
        for (idx, _), (wrb, _) in zip(C.SHARDED_LOCKS, want):
            rb[idx] = 0
            np.testing.assert_array_equal(wrb, rb)


@pytest.mark.parametrize("world", WORLDS)
def test_configure_mesh_refuses_uneven_lanes_as_repro(world, oracle, ranks):
    assert oracle[world]["refused"] == "ProtocolError"
    for r in ranks[world]:
        assert r["refused"] == "ProtocolError"


@pytest.mark.parametrize("world", WORLDS)
def test_meshed_registry_revoke_drains_and_clears_the_lane(world, oracle,
                                                           ranks):
    want = oracle[world]["registry"]
    for r in ranks[world]:
        got = r["registry"]
        assert got["held"] == want["held"] == 0
        assert got["scans"] >= 1 and got["unmeshed_scans"] >= 1
        np.testing.assert_array_equal(got["rbias"], want["rbias"])
        assert got["rbias"][1] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_matches_repro(world, oracle, ranks):
    for r in ranks[world]:
        for (gm, ge), (wm, we) in zip(r["compressed"],
                                      oracle[world]["compressed"]):
            for got, want in ((gm, wm), (ge, we)):
                scale = max(float(np.abs(want).max()), 1e-30)
                assert np.abs(got - want).max() <= REL * scale


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_of_each_ranks_own_leaf(world, ranks):
    """Ranks that hold different leaves: the mean over the data axes is
    the int32 sum of their int8 payloads times the largest scale among
    them, the same on each rank of a group (the ranks that share every
    other coordinate); each keeps its own residual."""
    rs = ranks[world]
    for r in rs:
        group = [o for o in rs if all(o["coords"][a] == r["coords"][a]
                                      for a in r["coords"]
                                      if a not in ("pod", "data"))]
        q_sum = sum(o["own_leaf"][2].astype(np.int32) for o in group)
        s_max = max(np.float32(o["own_leaf"][3]) for o in group)
        want = q_sum.astype(np.float32) * s_max / np.float32(len(group))
        mean, new_err, q, scale = r["own_leaf"]
        np.testing.assert_allclose(mean, want, rtol=REL, atol=0)
        assert np.abs(new_err).max() <= np.float32(scale) / 2 * (1 + REL)


@pytest.mark.parametrize("decode", [False, True], ids=["train", "decode"])
@pytest.mark.parametrize("world", WORLDS)
def test_reshard_tree_blocks_equal_jax_shards(world, decode, oracle, ranks):
    want = oracle[world]["reshard"][decode]
    for rank, r in enumerate(ranks[world]):
        got = r["reshard"][decode]
        assert sorted(got) == sorted(want)
        for path, shards in want.items():
            np.testing.assert_array_equal(got[path], shards[rank],
                                          err_msg=path)
