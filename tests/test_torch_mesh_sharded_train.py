"""The sharded train step (``make_train_step``/``jit_train_step`` with
``sharded=True``) of the llama3.2-1b smoke config on gloo worlds of
(data, model) = (2, 1), (1, 2), (2, 2) and ("pod", "data", "model") = (2,
2, 2), against ``repro``'s step jitted with ``launch/dryrun.py``'s
shardings on fake XLA devices at the same mesh shapes.  Per case, on
every rank: the loss, gradient norm and step count; each moment block
against device ``r``'s ``addressable_shards`` of ``repro``'s moments;
each parameter block's update against ``repro``'s shard within R14's
bound; the shapes the rank stores (only its blocks); the gathered trees
against the port's own unsharded step; replicated blocks bit-equal across
ranks; the graphed step in place and equal to the eager one.  The
tolerances are ``torch_sharded_cases``'."""

import numpy as np
import pytest

import torch_mesh_cases as C
import torch_sharded_cases as SC

CASES = [c for c in SC.CASES if c[0] == "llama3.2-1b"]
IDS = [SC.case_id(c) for c in CASES]


@pytest.fixture(scope="module")
def oracle():
    return C.jax_oracle(SC.ORACLE, SC.oracle_inputs(CASES))


@pytest.fixture(scope="module")
def ranks(oracle):
    out = {}
    for arch, shape, names in CASES:
        out[(arch, shape)] = C.run_ranks(
            "torch_sharded_cases:rank_sharded_train", int(np.prod(shape)),
            arch, shape, names, oracle["params"][arch],
            SC.batch(C.smoke_f32(arch)))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_loss_and_grad_norm_match_repro(case, oracle, ranks):
    SC.check_loss_and_norm(case, ranks[case[:2]], oracle)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_moment_blocks_match_repros_shards(case, oracle, ranks):
    SC.check_moments(case, ranks[case[:2]], oracle)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_param_blocks_match_repros_shards(case, oracle, ranks):
    SC.check_param_updates(case, ranks[case[:2]], oracle)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_each_rank_stores_only_its_blocks(case, ranks):
    SC.check_stored_blocks(case, ranks[case[:2]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gathered_step_equals_the_unsharded_step(case, ranks):
    SC.check_gathered_equals_unsharded(ranks[case[:2]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_replicated_blocks_are_bit_equal(case, ranks):
    SC.check_replicas_bit_equal(case, ranks[case[:2]])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graphed_step_is_in_place_and_equals_eager(case, ranks):
    SC.check_jit_in_place(ranks[case[:2]])
