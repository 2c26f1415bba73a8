"""Expert-parallel MoE and the data-sharded paged wrappers: the port on a
gloo world of 4 ranks against ``repro`` on fake devices at the same mesh
shape.

* The three MoE bodies through ``moe_forward`` — the capacity dispatch
  with its two all-to-alls over "model", the same with the experts' d_ff
  resident over the data axes, and the dropless decode body — on the
  ``(2, 2)`` ("data", "model") and ``(1, 2, 2)`` ("pod", "data", "model")
  meshes, at the phi3.5-moe and llama4 smoke configs (llama4 adds the
  shared expert outside the sharded part), on random tokens and on a batch
  of identical tokens that overflows every shard's capacity.  The
  capacity is counted on each shard's own tokens, so the overflowing
  batch drops other tokens than the one-device layer does: the reference
  is ``repro`` at the same mesh shape.
* The four paged wrappers (K5-K8 through their plain versions here) on a
  batch of 4 rows sharded over "data" of the (2, 2) mesh, against
  ``repro``'s wrappers running the Pallas kernels in interpret mode.

Tolerance: 1e-5 of the largest element on float32 activations (every side
computes in float32; sums run in other orders), the aux loss 1e-6
relative (a mean over the ranks of each shard's loss).
"""

import numpy as np
import pytest

import torch_mesh_cases as C

REL = 1e-5
AUX_REL = 1e-6

ORACLE = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.models import transformer as JT

devs = np.array(jax.devices())
meshes = {name: Mesh(devs[:4].reshape(shape), names)
          for name, (shape, names) in INPUTS["meshes"].items()}
OUT["params"] = {}
for arch in INPUTS["archs"]:
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              compute_dtype=jnp.float32,
                              param_dtype=jnp.float32)
    p = jax.tree.map(lambda a: np.asarray(a[0]),
                     JT.init_moe(jax.random.PRNGKey(0), cfg, 1))
    OUT["params"][arch] = p
    for name, mesh in meshes.items():
        data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        for body, decode_tp, resident, split in INPUTS["bodies"]:
            fn = jax.jit(lambda p, x: JT.moe_forward(
                p, x, cfg, mesh, data_axes, split, decode_tp=decode_tp,
                weight_resident=resident))
            for kind, x in INPUTS["x"][arch].items():
                with mesh:
                    y, aux = fn(p, jnp.asarray(x))
                OUT[(arch, name, body, kind)] = (np.asarray(y), float(aux))
t = {k: jnp.asarray(v) for k, v in INPUTS["paged"].items()}
mesh, axes = meshes["2x2"], ("data",)
with mesh:
    OUT["paged"] = np.asarray(JT._paged_attention_sharded(
        t["q1"], t["kp"], t["vp"], t["pages"], t["clen"], mesh, axes))
    OUT["chunk"] = np.asarray(JT._paged_chunk_attention(
        t["qs"], t["kp"], t["vp"], t["pages"], t["clen"], t["nlen"], mesh,
        axes))
    OUT["paged_quant"] = np.asarray(JT._paged_attention_quant_sharded(
        t["q1"], t["kq"], t["vq"], t["ks"], t["vs"], t["pages"], t["clen"],
        mesh, axes))
    OUT["chunk_quant"] = np.asarray(JT._paged_chunk_attention_quant(
        t["qs"], t["kq"], t["vq"], t["ks"], t["vs"], t["pages"], t["clen"],
        t["nlen"], mesh, axes))
"""


def _d_model(arch):
    return C.smoke_f32(arch).d_model


@pytest.fixture(scope="module")
def oracle():
    return C.jax_oracle(ORACLE, {
        "archs": C.MOE_ARCHS, "meshes": C.MOE_MESHES,
        "bodies": C.MOE_BODIES, "paged": C.paged_inputs(),
        "x": {a: C.moe_inputs(_d_model(a)) for a in C.MOE_ARCHS}})


@pytest.fixture(scope="module")
def ranks(oracle):
    return C.run_ranks("rank_moe", 4, oracle["params"], C.paged_inputs())


def _close(got, want, rel=REL):
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= rel * scale, \
        (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("kind", ["random", "same"])
@pytest.mark.parametrize("body", [b[0] for b in C.MOE_BODIES])
@pytest.mark.parametrize("mesh", sorted(C.MOE_MESHES))
@pytest.mark.parametrize("arch", C.MOE_ARCHS)
def test_moe_body_matches_repro_at_the_same_mesh(arch, mesh, body, kind,
                                                 oracle, ranks):
    wy, waux = oracle[(arch, mesh, body, kind)]
    for r in ranks:
        gy, gaux = r[(arch, mesh, body, kind)]
        _close(gy, wy)
        assert abs(gaux - waux) <= AUX_REL * abs(waux)


@pytest.mark.parametrize("arch", C.MOE_ARCHS)
def test_overflowing_batch_drops_per_shard(arch, oracle):
    """On identical tokens every shard overflows its own capacity: the
    meshed capacity body drops tokens (rows exactly 0 without the shared
    expert's term, which phi3.5-moe lacks), and other rows than a shard of
    4 times the tokens would."""
    y, _ = oracle[(arch, "2x2", "capacity", "same")]
    if arch.startswith("phi"):
        dropped = (y.reshape(-1, y.shape[-1]) == 0).all(-1)
        assert 0 < dropped.sum() < dropped.size


@pytest.mark.parametrize("name", ["paged", "chunk", "paged_quant",
                                  "chunk_quant"])
def test_paged_wrappers_shard_rows_as_repro(name, oracle, ranks):
    want = oracle[name]
    for r in ranks:
        _close(r[name], want)
    # the empty last row is exactly zero on every rank
    for r in ranks:
        assert not r[name][-1].any()


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 2)])
def test_dropless_body_refuses_a_second_live_data_axis(shape):
    """The dropless body splits the experts' d_ff over "data" alone and
    sums over every data axis, so with "pod" above 1 it would add up each
    pod's copy of the same partial output (ROADMAP R15): the port raises
    before any collective, where ``repro`` returns a multiple."""
    import torch
    from repro_torch.dist.sharding import ShapeMesh
    from repro_torch.models import transformer as TT

    cfg = C.smoke_f32("phi3.5-moe-42b-a6.6b")
    gen = torch.Generator().manual_seed(0)
    p = {k: v[0] for k, v in TT.init_moe(gen, cfg, 1).items()}
    x = torch.from_numpy(C.moe_inputs(cfg.d_model)["random"])
    mesh = ShapeMesh(("pod", "data", "model"), shape)
    with pytest.raises(NotImplementedError, match="pod"):
        TT.moe_forward(p, x, cfg, mesh, ("pod", "data"), True,
                       decode_tp=True)
