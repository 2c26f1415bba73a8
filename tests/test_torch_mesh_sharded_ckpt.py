"""Checkpoints of the sharded train step and the elastic restart, at the
llama3.2-1b smoke config (float32): one sharded step at (data, model) =
(2, 2), its parameters and AdamW state saved by ``save_checkpoint`` with
their specs (rank 0 writes the gathered leaves) and, for comparison,
gathered by ``unshard_tree`` and saved whole.

* The two checkpoints hold the same bytes: the manifests (shapes,
  dtypes, CRCs) are the same text, and so is every leaf's ``.npy``
  member.
* ``repro``'s ``load_checkpoint`` reads the sharded save back, every leaf
  equal to the whole array.
* Loaded and placed (``reshard_tree``, ``reshard_opt_state``) at (2, 1)
  and (1, 1), the next step's loss and gradient norm are within ``REL``
  of the uninterrupted run's step 2 at (2, 2), and each rank holds its
  blocks of the new mesh.
"""

import os
import zipfile

import numpy as np
import pytest

import torch_mesh_cases as C
import torch_sharded_cases as SC

REL = 1e-5
SAVE = ((2, 2), ("data", "model"))
RESTORE = {"2x1": ((2, 1), ("data", "model")),
           "1x1": ((1, 1), ("data", "model"))}

ORACLE = """
import jax, numpy as np
from repro.ft.checkpoint import load_checkpoint
like = jax.tree.map(np.zeros_like, INPUTS["like"])
got = load_checkpoint(INPUTS["dir"], 1, like)
OUT["leaves"] = [np.asarray(x) for x in jax.tree.leaves(got)]
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    shape, names = SAVE
    saved = C.run_ranks("torch_sharded_cases:rank_ckpt_save",
                        int(np.prod(shape)), shape, names, d)
    restored = {k: C.run_ranks("torch_sharded_cases:rank_ckpt_restore",
                               int(np.prod(s)), s, n, d)
                for k, (s, n) in RESTORE.items()}
    return d, saved, restored


def _np_tree(tree):
    """The tree with numpy zeros of each leaf's shape (``repro``'s
    ``like``)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.zeros(tuple(np.shape(tree)), np.float32)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_sharded_save_writes_the_whole_arrays(run):
    d = run[0]
    a, b = (os.path.join(d, k, "step_000000001") for k in ("sharded",
                                                            "whole"))
    with open(os.path.join(a, "manifest.json")) as f:
        ma = f.read()
    with open(os.path.join(b, "manifest.json")) as f:
        assert f.read() == ma
    shards = sorted(n for n in os.listdir(a) if n.endswith(".npz"))
    assert shards == sorted(n for n in os.listdir(b) if n.endswith(".npz"))
    for n in shards:
        assert _members(os.path.join(a, n)) == _members(os.path.join(b, n))


def test_repro_reads_the_sharded_checkpoint(run):
    from repro_torch.ft.checkpoint import load_checkpoint, tree_flatten
    from repro_torch.models import model as TM

    d = run[0]
    like_t = {"params": TM.init_params(0, C.smoke_f32(SC.CKPT_ARCH),
                                       device="cpu")}
    like_t["opt"] = {"m": like_t["params"], "v": like_t["params"],
                     "step": np.zeros((), np.int32)}
    like = _np_tree(like_t)
    got = C.jax_oracle(ORACLE, {"dir": os.path.join(d, "sharded"),
                                "like": like})["leaves"]
    want = tree_flatten(load_checkpoint(os.path.join(d, "whole"), 1,
                                        like_t))[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("mesh", list(RESTORE))
def test_restore_on_another_mesh_continues_the_run(run, mesh):
    _, saved, restored = run
    ref = saved[0]
    for r in restored[mesh]:
        for k in ("loss", "grad_norm"):
            assert abs(r[k] - ref[k][1]) <= REL * abs(ref[k][1]), \
                (mesh, k, r[k], ref[k])
    shape, names = RESTORE[mesh]
    want = SC.expected_blocks(SC.CKPT_ARCH, shape, names)["params"]
    for r in restored[mesh]:
        assert r["stored"] == want
