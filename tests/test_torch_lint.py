"""The port's source lint (``repro_torch.analysis.lint_src``): the twin of
``tests/test_lint.py``'s source-lint tests.  The port lints clean; each of
PyTorch's host syncs inside a lease window is found; the reference's rules
find on the reference's snippets what the reference's lint finds."""

import os
import textwrap

import pytest

from repro.analysis import lint_src as RLS
from repro_torch.analysis import check as CHK
from repro_torch.analysis import lint_src as LS

ALLOWLIST = os.path.join(LS.SRC_ROOT, "analysis", "lint_allowlist.txt")

LEASE_WINDOW = textwrap.dedent("""\
    import numpy as np
    import torch
    def step(self, tok, ids):
        try:
            nxt = self._decode(tok)
            {sync}
        finally:
            self.store.done_read_batch(tok, ids)
        ok = {sync_after}   # after release: fine
    """)


def _same(got, want):
    return [(f.rule, f.where, f.message) for f in got] == \
        [(f.rule, f.where, f.message) for f in want]


def test_src_tree_is_clean():
    assert LS.SRC_ROOT.endswith(os.path.join("src", "repro_torch"))
    assert LS.apply_allowlist(LS.lint_tree(),
                              LS.load_allowlist(ALLOWLIST)) == []
    assert LS.load_allowlist(ALLOWLIST) == []     # nothing waived
    assert LS.lint_tree() == []


def test_the_engine_has_lease_windows_to_lint():
    """The rules have something to read: the port's engine releases leases
    in ``finally`` blocks."""
    import ast

    with open(os.path.join(LS.SRC_ROOT, "serving", "engine.py")) as f:
        tree = ast.parse(f.read())
    windows = [t for t in ast.walk(tree) if isinstance(t, ast.Try)
               and t.finalbody and LS._releases_lease(t.finalbody)]
    assert len(windows) >= 4


def test_shard_map_outside_dist():
    src = "from jax.experimental.shard_map import shard_map\n"
    assert [f.rule for f in LS.lint_file("serving/kv_pool.py", src)] == \
        ["shard-map-outside-dist"]
    assert LS.lint_file("dist/sharding.py", src) == []


@pytest.mark.parametrize("sync,label", [
    ("nxt.item()", "item"),
    ("nxt.cpu()", "cpu"),
    ("nxt.tolist()", "tolist"),
    ("nxt.numpy()", "numpy"),
    ("torch.cuda.synchronize()", "synchronize"),
    ("torch.cuda.current_stream().synchronize()", "synchronize"),
    ("np.asarray(nxt)", "np.asarray"),
    ("nxt.block_until_ready()", "block_until_ready"),
])
def test_host_sync_in_lease_window(sync, label):
    src = LEASE_WINDOW.format(sync=sync, sync_after=sync)
    fs = LS.lint_file("serving/engine.py", src)
    assert [f.rule for f in fs] == ["host-sync-in-lease-window"]
    assert fs[0].where == "serving/engine.py:6"
    assert fs[0].message.startswith(f"{label} while a lease is held")
    # the rule reads the engine only, as the reference's does
    assert LS.lint_file("serving/kv_pool.py", src) == []


def test_async_copies_inside_the_window_are_fine():
    for ok in ("nxt.to(self.dev, non_blocking=True)", "torch.as_tensor(x)",
               "jnp.asarray(nxt)", "nxt.copy_(tok)"):
        src = LEASE_WINDOW.format(sync=ok, sync_after="nxt.item()")
        assert LS.lint_file("serving/engine.py", src) == []


def test_reference_sync_rules_match_the_reference():
    src = textwrap.dedent("""\
        import numpy as np
        def step(self, tok, ids):
            try:
                nxt = self._decode(tok)
                bad = np.asarray(nxt)
                nxt.block_until_ready()
            finally:
                self.store.done_read_batch(tok, ids)
            ok = np.asarray(nxt)   # after release: fine
        """)
    fs = LS.lint_file("serving/engine.py", src)
    assert [f.rule for f in fs] == ["host-sync-in-lease-window"] * 2
    assert {f.where for f in fs} == {"serving/engine.py:5",
                                     "serving/engine.py:6"}
    assert _same(fs, RLS.lint_file("serving/engine.py", src))
    fs2 = LS.lint_file("serving/engine.py",
                       src.replace("np.asarray", "jnp.asarray"))
    assert [f.rule for f in fs2] == ["host-sync-in-lease-window"]


def test_obs_in_lease_window():
    src = textwrap.dedent("""\
        def step(self, tok, ids):
            try:
                nxt = self._decode(tok)
                if _TR.enabled:
                    _TR.emit("engine", "decode_step", batch=4)   # ok
                self._c_steps.add(1)                             # ok
                _TR.snapshot()                                   # bad
                p99 = self.metrics.histogram("engine.step_ns").quantile(0.99)
                dump = format_timeline(_TR.snapshot())
            finally:
                self.store.done_read_batch(tok, ids)
            snap = self.metrics.snapshot()   # after release: fine
        """)
    fs = LS.lint_file("serving/engine.py", src)
    obs = [f for f in fs if f.rule == "obs-in-lease-window"]
    lines = sorted(int(f.where.split(":")[1]) for f in obs)
    assert lines == [7, 8, 9]
    fs2 = LS.lint_file("serving/kv_pool.py", src)
    assert [f.rule for f in fs2] == ["obs-in-lease-window"] * 3
    assert _same(fs, RLS.lint_file("serving/engine.py", src))
    assert _same(fs2, RLS.lint_file("serving/kv_pool.py", src))


def test_scheduler_state_mutation():
    src = textwrap.dedent("""\
        class E:
            def __init__(self, sc):
                self.scheduler = sc          # rebinding: allowed
            def ok(self):
                self.scheduler.submit(1)     # method call: allowed
            def bad(self):
                self.scheduler.budget += 1
                self.scheduler.running[0] = None
                del self.scheduler.queue
        """)
    fs = LS.lint_file("serving/engine.py", src)
    assert [f.rule for f in fs] == ["scheduler-state-mutation"] * 3
    assert {f.where.split(":")[1] for f in fs} == {"7", "8", "9"}
    assert _same(fs, RLS.lint_file("serving/engine.py", src))


def test_allowlist_waives_narrowly(tmp_path):
    f = LS.Finding("host-sync-in-lease-window", "serving/engine.py:755",
                   "item while a lease is held")
    other = LS.Finding("scheduler-state-mutation", "serving/engine.py:755",
                       "assignment")
    al = tmp_path / "allow.txt"
    al.write_text("# comment\n"
                  "host-sync-in-lease-window engine.py:755 item\n")
    entries = LS.load_allowlist(str(al))
    assert entries == RLS.load_allowlist(str(al))
    kept = LS.apply_allowlist([f, other], entries)
    assert kept == [other]
    assert str(f) == "host-sync-in-lease-window: [serving/engine.py:755] " \
                     "item while a lease is held"


def test_check_reports_the_missing_stage_and_fails_on_a_finding(
        monkeypatch, capsys):
    assert CHK.main(["--skip-checker"]) == 0
    out = capsys.readouterr().out
    assert CHK.NO_HLO in out.splitlines()
    assert "SKIP" not in out and "analysis: OK" in out
    bad = LS.Finding("host-sync-in-lease-window", "serving/engine.py:1",
                     "item while a lease is held")
    monkeypatch.setattr(CHK, "lint_tree", lambda: [bad])
    assert CHK.main(["--skip-checker"]) == 1
    assert "FAIL host-sync-in-lease-window" in capsys.readouterr().out


@pytest.mark.parametrize("mutation", ["release-token-mismatch",
                                      "cow-write-through"])
def test_check_mutation_is_found(mutation, capsys):
    assert CHK.main(["--skip-src", "--mutation", mutation]) == 0
    assert f"mutation '{mutation}' ->" in capsys.readouterr().out
