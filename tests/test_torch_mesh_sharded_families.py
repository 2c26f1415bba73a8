"""The sharded train step of the other layouts of the slice at (data,
model) = (2, 2), against ``repro``'s step jitted with
``launch/dryrun.py``'s shardings on fake XLA devices: granite-20b (MQA,
its one K/V head replicated, a GELU MLP, an untied head),
phi-3-vision-4.2b (the vlm frontend's patch embeddings, K/V heads over
"model") and hubert-xlarge (audio frame embeddings, an encoder, a loss
mask).  The same checks as tests/test_torch_mesh_sharded_train.py's.
And the refusals: gemma-2b (seqshard attention), minicpm-2b (seqshard,
residual_seq) and phi3.5-moe (an MoE stack) raise
``NotImplementedError`` naming what is missing, from both steps."""

import numpy as np
import pytest

import torch_mesh_cases as C
import torch_sharded_cases as SC

CASES = [c for c in SC.CASES if c[0] != "llama3.2-1b"]
IDS = [SC.case_id(c) for c in CASES]
MISSING = {"gemma-2b": ("seqshard attention",),
           "minicpm-2b": ("seqshard attention", "residual_seq"),
           "phi3.5-moe-42b-a6.6b": ("the moe stack's dense leaves",)}


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


@pytest.mark.parametrize("arch", SC.REFUSED)
def test_unsupported_layouts_refuse(arch):
    """No whole-weight fallback: both steps raise before anything runs,
    naming each missing layout."""
    import torch

    from repro_torch import configs as TC
    from repro_torch.dist.sharding import ShapeMesh
    from repro_torch.models import model as TM
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_step as TT

    cfg, rules, _ = TC.get(arch)
    mesh = ShapeMesh(("data", "model"), (2, 2))
    for make in (TT.make_train_step, TT.jit_train_step):
        with pytest.raises(NotImplementedError) as e:
            make(cfg, TO.OptimizerConfig(), mesh, rules, sharded=True)
        for what in MISSING[arch]:
            assert what in str(e.value), (what, str(e.value))
    # the model refuses a sharded forward of its stack too
    smoke = TC.get_smoke(arch)
    if smoke.family not in ("dense", "vlm", "audio"):
        p = TM.init_params(0, smoke, device="cpu")
        tokens = torch.zeros((1, 4), dtype=torch.int32)
        with pytest.raises(NotImplementedError):
            TM.forward(p, smoke, {"tokens": tokens}, mesh=mesh, rules=rules,
                       specs={})
