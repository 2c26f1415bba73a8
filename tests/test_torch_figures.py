"""The port's lock experiments (``repro_torch.benchmarks.{common,figures,
run}``) against the reference's ``benchmarks`` on the same small cases:
the coherence simulator is deterministic, so every figure function returns
the same ``BenchResult``, field for field, and the same CSV row; and the
run CLI's quick ``--only fig2`` prints and writes what the reference's
does.  Times are virtual time on the modelled 72-CPU X5-2."""

import dataclasses
import itertools
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks import figures as RF  # noqa: E402
from repro.core import table as RT  # noqa: E402
from repro_torch.benchmarks import common as TC  # noqa: E402
from repro_torch.benchmarks import figures as TF  # noqa: E402
from repro_torch.core import table as TT  # noqa: E402

BUDGET = 100_000      # virtual ns

CASES = {
    "interference_shared": ("interference", (4,),
                            dict(nthreads=4, budget_ns=BUDGET, shared=True)),
    "interference_private": ("interference", (4,),
                             dict(nthreads=4, budget_ns=BUDGET,
                                  shared=False)),
    "alternator_ba": ("alternator", ("ba", 4), dict(rounds=50)),
    "alternator_bravo": ("alternator", ("bravo-ba", 4), dict(rounds=50)),
    "test_rwlock_ba": ("test_rwlock", ("ba", 4), dict(budget_ns=BUDGET)),
    "test_rwlock_bravo": ("test_rwlock", ("bravo-ba", 4),
                          dict(budget_ns=BUDGET)),
    "test_rwlock_cohort": ("test_rwlock", ("cohort-rw", 4),
                           dict(budget_ns=BUDGET)),
    "rwbench_bravo": ("rwbench", ("bravo-ba", 4, 0.1),
                      dict(budget_ns=BUDGET)),
    "rwbench_percpu": ("rwbench", ("percpu", 4, 0.01),
                       dict(budget_ns=BUDGET)),
    "kv_bravo": ("kv_readwhilewriting", ("bravo-ba", 4),
                 dict(budget_ns=BUDGET, write_work=4000)),
    "kv_pthread": ("kv_readwhilewriting", ("bravo-pthread", 4),
                   dict(budget_ns=BUDGET, write_work=40000)),
    "hash_table_bravo": ("hash_table_bench", ("bravo-ba", 4),
                         dict(budget_ns=BUDGET)),
    "locktorture_w1": ("locktorture", ("bravo-ba", 4),
                       dict(writers=1, read_hold_ns=5000, write_hold_ns=1000,
                            budget_ns=BUDGET)),
    "locktorture_w0": ("locktorture", ("ba", 4),
                       dict(writers=0, read_hold_ns=5000, write_hold_ns=0,
                            budget_ns=BUDGET)),
    "metis_bravo": ("metis_analogue", ("bravo-ba", 4, 0.3),
                    dict(budget_ns=BUDGET)),
    "metis_ba": ("metis_analogue", ("ba", 4, 0.02), dict(budget_ns=BUDGET)),
}


@pytest.fixture(autouse=True)
def _fresh_lock_ids(monkeypatch):
    """Each package numbers its locks from one process-wide counter, and a
    BRAVO lock's reader slots hash its number: start both counters at 1 so
    that the twins build the same locks whatever ran earlier."""
    monkeypatch.setattr(RT, "_lock_ids", itertools.count(1))
    monkeypatch.setattr(TT, "_lock_ids", itertools.count(1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_figure_equals_reference(case):
    fn, args, kw = CASES[case]
    want = getattr(RF, fn)(*args, **kw)
    got = getattr(TF, fn)(*args, **kw)
    assert isinstance(got, TC.BenchResult)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    assert got.ops > 0 and got.elapsed_ns > 0


def test_every_figure_function_is_twinned():
    names = {n for n in dir(RF) if callable(getattr(RF, n))
             and not n.startswith("_")
             and getattr(getattr(RF, n), "__module__", "") == RF.__name__}
    assert names <= {n for n in dir(TF) if callable(getattr(TF, n))}
    assert {fn for fn, _, _ in CASES.values()} == names - {"run_timed_named"}


def test_x5_2_topology_and_thread_grids():
    from benchmarks import common as RC

    assert TC.X5_2.num_cpus == RC.X5_2.num_cpus == 72
    assert (TC.X5_2.sockets, TC.X5_2.cores_per_socket, TC.X5_2.smt) == \
        (RC.X5_2.sockets, RC.X5_2.cores_per_socket, RC.X5_2.smt)
    assert TC.DEFAULT_THREADS == RC.DEFAULT_THREADS
    assert TC.QUICK_THREADS == RC.QUICK_THREADS
    assert [TC.XorShift(7).next() for _ in range(3)] == \
        [RC.XorShift(7).next() for _ in range(3)]


def test_run_cli_fig2_equals_reference(tmp_path):
    """``--only fig2 --json-out``: the quick run's 9 rows, stdout and JSON
    alike, from both CLIs run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for who, mod in (("ref", "benchmarks.run"),
                     ("port", "repro_torch.benchmarks.run")):
        out = tmp_path / f"{who}.json"
        procs[who] = (out, subprocess.Popen(
            [sys.executable, "-m", mod, "--only", "fig2", "--json-out",
             str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    got = {}
    for who, (out, p) in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr
        got[who] = (stdout, json.loads(out.read_text()))
    assert got["port"] == got["ref"]
    stdout, rows = got["port"]
    assert stdout.splitlines()[0] == "name,us_per_call,derived"
    assert len(rows) == 9 and all(r["bench"] == "fig2_alternator"
                                  for r in rows)


def test_run_has_no_roofline_entry():
    from repro_torch.benchmarks import run as TR

    assert "roofline" not in TR.ALL
    assert list(TR.ALL) == ["fig1", "fig2", "fig3", "fig4", "fig5", "fig6",
                            "fig7", "fig8", "metis"]
