"""The port's fault matrix (``repro_torch.ft.faults``) on the smoke
config with ``repro``'s float32 parameters, on the CPU: the last three
faults (pool exhaustion, a corrupt checkpoint, an updater crash), each
returning every invariant True with tokens equal to ``repro``'s golden
run.  The matrix is split over two files so that each runs in well under
a minute on one test worker."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.ft import faults as JF
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.ft import faults as TF
from repro_torch.models import model as TM


@pytest.fixture(scope="module")
def golden():
    """(port config, port params, ``repro``'s golden tokens)."""
    cj = dataclasses.replace(JC.get_smoke("llama3.2-1b"),
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke("llama3.2-1b"),
                             compute_dtype=torch.float32)
    jp = JM.init_params(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return ct, tp, [list(map(int, t)) for t in JF.golden_run(cj, jp)]


@pytest.mark.parametrize("fault", TF.FAULTS[4:])
def test_fault_holds_every_invariant(golden, fault):
    ct, tp, want = golden
    res = TF.run_fault(fault, 0, ct, tp, golden=want, device="cpu")
    bad = {k: v for k, v in res.items() if v is False}
    assert res["ok"] and not bad, res
    assert res["tokens_exact"] and res["table_clean"] and res["free_ok"]


def test_corrupt_copy_links_the_shards(tmp_path):
    """The corrupted copy holds a manifest of its own and links the
    source's shards: no shard is written twice, and the source stays
    whole."""
    from repro_torch.ft import checkpoint as CK

    tree = {"b": torch.arange(5, dtype=torch.float32),
            "a": torch.ones((2, 3))}
    CK.save_checkpoint(tmp_path, 1, tree)
    bad = TF.corrupt_copy(tmp_path, 1, 2, leaf=1)
    for fn in CK.read_manifest(tmp_path, 1)["shards"]:
        assert (bad / fn).is_symlink()
    with pytest.raises(CK.CheckpointCorrupt) as e:
        CK.load_checkpoint(tmp_path, 2, like=tree)
    assert e.value.leaf == 1
    assert torch.equal(CK.load_checkpoint(tmp_path, 1, like=tree)["b"],
                       tree["b"])
