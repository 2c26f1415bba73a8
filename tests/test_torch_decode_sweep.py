"""The decode kernel's timing sweep (``repro_torch.benchmarks.
decode_sweep``) on the CPU: its cases hold what the kernel is timed on (each
row on its own pages, -1 lanes past its length, the byte count of the
valid rows), and without a CUDA card it exits 1 and times nothing."""

import pytest
import torch

from repro_torch.benchmarks import decode_sweep as DS
from repro_torch.kernels import ref as R


@pytest.mark.parametrize("int8", [False, True])
def test_case_rows_pages_and_bytes(int8):
    b, lanes, ps, h, kvh, hd = 3, 5, 4, 4, 2, 16
    case = DS.make_case(b, lanes, ps, (6, 30), int8, seed=1, device="cpu",
                        h=h, kvh=kvh, hd=hd)
    pi, cl = case["page_idx"], case["cache_len"]
    assert pi.shape == (b, lanes) and pi.dtype == torch.int32
    assert bool((cl >= 6).all()) and bool((cl <= lanes * ps).all())
    used = pi[pi >= 0]
    assert used.numel() == torch.unique(used).numel()   # no page shared
    for i in range(b):
        npg = -(-int(cl[i]) // ps)
        assert bool((pi[i, :npg] >= 0).all()) and bool((pi[i, npg:] < 0).all())
    rows = int(cl.sum())
    kv = (2 * rows * kvh * hd + 2 * used.numel() * kvh * 4 if int8
          else 2 * rows * kvh * hd * 2)
    assert case["bytes"] == kv + 2 * b * h * hd * 4
    assert case["k"].dtype == (torch.int8 if int8 else torch.bfloat16)
    assert len(case["scales"]) == (2 if int8 else 0)
    out = (R.paged_attn_quant_ref(case["q"], case["k"], case["v"],
                                  *case["scales"], pi, cl) if int8
           else R.paged_attn_ref(case["q"], case["k"], case["v"], pi, cl))
    assert out.shape == (b, h, hd) and bool(torch.isfinite(out).all())


def test_no_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert DS.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
