"""``repro_torch.examples.serve_bravo``, the twin of ``repro``'s
``examples/serve_bravo.py``: handler mode on the smoke llama3.2-1b under
hot swaps and compaction, once for each model-epoch lock, on the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import torch

from repro_torch.examples import serve_bravo
from test_torch_graph_step import fake_graphs  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOCKS = ("bravo-ba", "ba", "bravo-pthread")


def test_module_runs_every_lock_on_the_cpu():
    """``python -m repro_torch.examples.serve_bravo --device cpu``: one
    line a lock with tokens/s, decode steps and swaps, the BRAVO locks'
    fast-path share and revocations, and a sample completion."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_bravo",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines()
             if not ln.startswith("  sample")]
    assert [ln.split()[0] for ln in lines] == list(LOCKS)
    for ln in lines:
        m = re.search(r"([\d.]+) tok/s\s+decode_steps=(\d+) swaps=(\d+)",
                      ln)
        assert m and float(m[1]) > 0 and int(m[2]) >= 44, ln
        assert ("fast-path=" in ln) == ln.startswith("bravo"), ln
    assert res.stdout.count("sample completion:") == len(LOCKS)


def test_readings_through_the_graphed_handler(fake_graphs):
    """The example's run on the graphed handler steps (stand-in graph):
    8 requests of 6 new tokens, at least 44 decode steps, every call a
    warm-up or a replay, the model lock's fast path counted."""
    out = serve_bravo.main(["--device", "cpu", "--locks", "bravo-ba",
                            "--requests", "8"])
    assert len(out) == 1
    r = out[0]
    assert r["lock"] == "bravo-ba" and r["decode_steps"] >= 44
    assert len(r["sample"]) == 6
    assert r["acquires"] >= r["decode_steps"]
    assert 0 <= r["fast_acquires"] <= r["acquires"]
    dec = [s["decode"] for s in r["handler_steps"].values()]
    assert sum(d["warmups"] + d["replays"] for d in dec) == r["decode_steps"]
    assert sum(d["replays"] for d in dec) > 0


def test_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        serve_bravo.main(["--locks", "ba"])
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("serve_bravo ran without a card")
