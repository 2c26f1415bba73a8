"""The port's sharding specs and shape stand-ins against ``repro``'s, with
no ranks: every spec function is a pure function of a mesh's axis names
and sizes.

For every config at full size (the port's parameter tree on the meta
device, ``repro``'s from ``jax.eval_shape``) and on the fake ``(2, 16,
16)`` ("pod", "data", "model") and ``(16, 16)`` ("data", "model") meshes
(``repro``'s side built as tests/test_sharding.py builds its 512-device
fake; the port's a ``ShapeMesh``), these equal ``repro``'s exactly, entry
for entry: ``param_specs`` (training and decode), ``zero1_specs``,
``cache_specs`` (sequence over "model", and over ("data", "model")),
``batch_spec`` of each batch leaf and ``logical_to_spec``.  The
``launch.specs`` stand-ins have ``repro``'s shapes and dtypes, and
``make_production_mesh`` refuses a world too small for it, as
``repro``'s refuses too few devices.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from repro import configs as JC
from repro.dist import sharding as JS
from repro.launch import specs as JL
from repro_torch import configs as TC
from repro_torch.dist import sharding as TS
from repro_torch.launch import mesh as TLM
from repro_torch.launch import specs as TL

ARCHS = list(TC.ARCH_IDS)
FAKE = {"multi": ((2, 16, 16), ("pod", "data", "model")),
        "single": ((16, 16), ("data", "model"))}
DECODE_B, DECODE_S = 128, 32768
TRAIN_B, TRAIN_S = 256, 4096


class _Dev:
    """A device stand-in for ``jax.sharding.Mesh`` (spec derivation only,
    as tests/test_sharding.py's ``fake_mesh``)."""

    def __init__(self, i):
        self.id = i
        self.platform = "cpu"
        self.device_kind = "cpu"
        self.process_index = 0


def _meshes(name):
    shape, names = FAKE[name]
    devs = np.empty(shape, object)
    for i in range(devs.size):
        devs.reshape(-1)[i] = _Dev(i)
    return Mesh(devs, names), TS.ShapeMesh(names, shape)


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _same_specs(jtree, ttree):
    jl, tl = list(_walk(jtree)), list(_walk(ttree))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert isinstance(j, JP) and isinstance(t, TS.P), path
        assert tuple(t) == tuple(j), (path, tuple(t), tuple(j))


def _rules(arch):
    jr, tr = JC.get(arch)[1], TC.get(arch)[1]
    assert tr == TS.MeshRules(**{f: getattr(jr, f)
                                 for f in jr.__dataclass_fields__})
    return jr, tr


def _shapes(arch):
    jcfg, tcfg = JC.get(arch)[0], TC.get(arch)[0]
    return jcfg, tcfg, JL.params_shape(jcfg), TL.params_shape(tcfg)


@pytest.mark.parametrize("mesh", sorted(FAKE))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_repro(arch, mesh):
    jm, tm = _meshes(mesh)
    jr, tr = _rules(arch)
    _, _, jshape, tshape = _shapes(arch)
    for decode in (False, True):
        js = JS.param_specs(jshape, jr, jm, decode=decode)
        ts = TS.param_specs(tshape, tr, tm, decode=decode)
        _same_specs(js, ts)
        _same_specs(JS.zero1_specs(js, jshape, jm),
                    TS.zero1_specs(ts, tshape, tm))


@pytest.mark.parametrize("mesh", sorted(FAKE))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_repro(arch, mesh):
    jm, tm = _meshes(mesh)
    jr, tr = _rules(arch)
    jcfg, tcfg = JC.get(arch)[0], TC.get(arch)[0]
    if jcfg.family != "audio":
        jc = JL.decode_specs(jcfg, DECODE_B, DECODE_S)[0]
        tc = TL.decode_specs(tcfg, DECODE_B, DECODE_S)[0]
        for seq in ((), ("model",), ("data", "model")):
            _same_specs(JS.cache_specs(jc, jr, jm, seq_axes=seq),
                        TS.cache_specs(tc, tr, tm, seq_axes=seq))
    jb = JL.batch_specs(jcfg, TRAIN_B, TRAIN_S)
    tb = TL.batch_specs(tcfg, TRAIN_B, TRAIN_S)
    for k in jb:
        for b in (TRAIN_B, 3, 1):
            shape = (b,) + tuple(jb[k].shape[1:])
            assert tuple(TS.batch_spec(tr, tm, shape)) == \
                tuple(JS.batch_spec(jr, jm, shape)), (k, b)


LOGICAL = [("batch", "seq_model", None), ("batch", None, "model"),
           ("fsdp", "model"), (("pod", "data"), "model"), ("data", "pod"),
           ("absent", "batch"), (None,), ()]


@pytest.mark.parametrize("mesh", sorted(FAKE))
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_to_spec_and_divisible_match_repro(arch, mesh):
    jm, tm = _meshes(mesh)
    jr, tr = _rules(arch)
    for axes in LOGICAL:
        js = JS.logical_to_spec(jr, jm, axes)
        ts = TS.logical_to_spec(tr, tm, axes)
        assert tuple(ts) == tuple(js), axes
        for shape in ((32, 48, 7), (6, 16, 256), (1, 1, 1)):
            shape = shape[:len(axes)]
            assert tuple(TS._divisible(ts, shape, tm)) == \
                tuple(JS._divisible(js, shape, jm)), (axes, shape)


def _same_shapes(jtree, ttree):
    jl, tl = list(_walk(jtree)), list(_walk(ttree))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).replace("torch.", "") == np.dtype(j.dtype).name


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_specs_match_repros_shape_structs(arch):
    jcfg, tcfg, jshape, tshape = _shapes(arch)
    _same_shapes(jshape, tshape)
    _same_shapes(JL.batch_specs(jcfg, 8, 512),
                 TL.batch_specs(tcfg, 8, 512))
    if jcfg.family == "audio":
        with pytest.raises(ValueError):
            JL.decode_specs(jcfg, 2, 16)
        with pytest.raises(ValueError):
            TL.decode_specs(tcfg, 2, 16)
        return
    jd, td = JL.decode_specs(jcfg, 4, 128), TL.decode_specs(tcfg, 4, 128)
    _same_shapes(jd[0], td[0])
    for j, t in zip(jd[1:], td[1:]):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).replace("torch.", "") == np.dtype(j.dtype).name


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_refuses_a_small_world(multi_pod):
    """``repro`` refuses when it has fewer devices than the mesh; the port
    when the world has fewer ranks (here: none started, one)."""
    n = 512 if multi_pod else 256
    if len(jax.devices()) < n:
        from repro.launch.mesh import make_production_mesh as jmake
        with pytest.raises(RuntimeError, match=f"need {n} devices"):
            jmake(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match=f"need {n} ranks"):
        TLM.make_production_mesh(multi_pod=multi_pod)


def test_local_mesh_refuses_without_a_card(monkeypatch):
    """No CUDA device and no ``device="cpu"``: ``make_local_mesh`` raises
    and never falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLM.make_local_mesh()
