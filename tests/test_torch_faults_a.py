"""The port's fault matrix (``repro_torch.ft.faults``) on the smoke
config with ``repro``'s float32 parameters, on the CPU: the first four
faults (the lease seams: delayed and dropped acks, a stalled reader, a
straggling host), each returning every invariant True with tokens equal
to ``repro``'s golden run.  The matrix is split over two files so that
each runs in well under a minute on one test worker."""

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


@pytest.mark.parametrize("fault", TF.FAULTS[:4])
def test_fault_holds_every_invariant(golden, fault):
    ct, tp, want = golden
    res = TF.run_fault(fault, 0, ct, tp, golden=want, device="cpu")
    bad = {k: v for k, v in res.items() if v is False}
    assert res["ok"] and not bad, res
    assert res["tokens_exact"] and res["table_clean"] and res["free_ok"]


def test_golden_run_and_the_fault_list_match_repro(golden):
    ct, tp, want = golden
    assert TF.golden_run(ct, tp, device="cpu") == want
    assert TF.FAULTS == JF.FAULTS


def test_injectors_are_seeded_as_in_repro():
    """The proxies' delay draws and the seeded choices come from the same
    generator, seeded as ``repro`` seeds it."""
    for fault in TF.FAULTS:
        a = np.random.default_rng(7 * 1000 + TF.FAULTS.index(fault))
        b = np.random.default_rng(7 * 1000 + JF.FAULTS.index(fault))
        ta = TF.DelayedRelease(object(), a)
        jb = JF.DelayedRelease(object(), b)
        assert np.array_equal(object.__getattribute__(ta, "_delays"),
                              object.__getattribute__(jb, "_delays"))
