"""The chunk kernel's timing sweep (``repro_torch.benchmarks.
chunk_sweep``) on the CPU: its cases hold what the kernel is timed on (each
row on its own pages, -1 lanes past its length, every column real, the
byte and operation counts of the visible positions), and without a CUDA
card it exits 1 and times nothing."""

import pytest
import torch

from repro_torch.benchmarks import chunk_sweep as CW
from repro_torch.kernels import ref as R


@pytest.mark.parametrize("int8", [False, True])
def test_case_rows_pages_bytes_and_operations(int8):
    b, s, lanes, ps, h, kvh, hd = 3, 4, 5, 4, 4, 2, 16
    case = CW.make_case(b, s, lanes, ps, int8, seed=1, device="cpu",
                        lengths=(6, 30), h=h, kvh=kvh, hd=hd)
    pi, cl, nl = case["page_idx"], case["cache_len"], case["new_lens"]
    assert pi.shape == (b, lanes) and pi.dtype == torch.int32
    assert bool((cl >= 6).all()) and bool((cl <= lanes * ps).all())
    assert bool((nl == s).all())
    used = pi[pi >= 0]
    assert used.numel() == torch.unique(used).numel()   # no page shared
    for i in range(b):
        npg = -(-int(cl[i]) // ps)
        assert bool((pi[i, :npg] >= 0).all()) and bool((pi[i, npg:] < 0).all())
    rows = int(cl.sum())
    kv = (2 * rows * kvh * hd + 2 * used.numel() * kvh * 4 if int8
          else 2 * rows * kvh * hd * 2)
    assert case["bytes"] == kv + 2 * b * s * h * hd * 4
    # column j of a row sees cache_len - s + j + 1 positions
    seen = sum(sum(int(c) - s + j + 1 for j in range(s)) for c in cl)
    assert case["ops"] == 4 * hd * h * seen
    assert case["k"].dtype == (torch.int8 if int8 else torch.bfloat16)
    args = (case["q"], case["k"], case["v"], *case["scales"], pi, cl, nl)
    out = (R.paged_chunk_attn_quant_ref(*args) if int8
           else R.paged_chunk_attn_ref(*args))
    assert out.shape == (b, s, h, hd) and bool(torch.isfinite(out).all())


def test_tick_case_takes_the_engine_lengths():
    case = CW.make_case(**CW.TICK, int8=False, seed=0, device="cpu")
    assert case["cache_len"].tolist() == [32, 72]
    assert case["page_idx"].shape == (2, 8)


def test_no_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert CW.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
