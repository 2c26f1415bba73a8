"""The port's protocol checker (``repro_torch.analysis.{checker,scenarios}``,
verbatim copies): the twin of ``tests/test_checker.py``, and parity with
the reference's ``Explorer``: at the same budget and seed, every scenario
explores the same number of schedules, and every seeded mutation is found
after the same number of schedules with the same minimised trace."""

import re

import pytest

from repro.analysis import checker as RC
from repro.analysis import scenarios as RS
from repro_torch.analysis import scenarios as S
from repro_torch.analysis.checker import (CheckMem, Explorer,
                                          InvariantViolation, format_trace)
from repro_torch.core.sim import SimMem, Topology


def _explore(name, mutation=None, max_schedules=None, seed=0,
             scenarios=S, explorer=Explorer):
    sc = scenarios.SCENARIOS[name]
    ex = explorer(lambda mem: sc.build(mem, mutation), name=name,
                  max_schedules=max_schedules or sc.max_schedules,
                  max_steps=sc.max_steps, seed=seed)
    return ex, ex.explore()


# ---------------------------------------------------------------------------
# machinery
# ---------------------------------------------------------------------------


def test_checkmem_is_deterministic():
    def trace(seed):
        ex, res = _explore("bravo-rw", max_schedules=50, seed=seed)
        return res.schedules, res.complete

    assert trace(0) == trace(0)
    assert trace(3) == trace(3)


def test_checkmem_counts_steps_and_events():
    mem = CheckMem()
    c = mem.alloc("x", 0)
    done = []

    def t0():
        c.fetch_add(1)
        done.append(mem.now())

    mem.run_threads([t0])
    assert mem.peek(c) == 1
    assert mem.events, "events recorded"
    assert done[0] > 0


def test_invariant_violation_reported_with_trace():
    mem = CheckMem()
    c = mem.alloc("flag", 0)

    def on_step(ev):
        if ev.kind == "store" and ev.value == 7:
            raise InvariantViolation("no-sevens", "stored 7")

    mem.on_step = on_step
    mem.run_threads([lambda: c.store(7)])
    assert mem.violation is not None
    assert mem.violation.invariant == "no-sevens"
    assert "no-sevens" in format_trace(mem.violation)


def test_deadlock_detected():
    def build(mem):
        a = mem.alloc("a", 0)

        def t0():
            mem.wait_while(a, lambda v: v == 0)   # nobody ever stores

        from types import SimpleNamespace
        return SimpleNamespace(threads=[t0], check=None, at_end=None)

    ex = Explorer(build, name="deadlock", max_schedules=10)
    res = ex.explore()
    assert res.violation is not None
    assert res.violation.invariant == "deadlock"


# ---------------------------------------------------------------------------
# clean scenarios — the port's copies uphold their invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,budget", [
    ("bravo-rw", None),          # fully explored (~900 schedules)
    ("bravo-2r1w", 1000),
    ("registry-model", 1000),
    ("parking-model", 1000),
    ("kvpool-model", 1000),
    ("quant-scale-model", 1000),
    ("controller-model", None),  # fully explored (~400 schedules)
])
def test_clean_scenarios_no_violation(name, budget):
    ex, res = _explore(name, max_schedules=budget)
    assert res.violation is None, format_trace(res.violation)
    if name in ("bravo-rw", "controller-model"):
        assert res.complete, "small scenario should be exhausted"


# ---------------------------------------------------------------------------
# seeded mutations — the checker finds each, and the trace replays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mutation,expect_invariant", [
    ("release-token-mismatch", "reader-count-underflow"),
    ("drain-off-by-one", "writer-exclusion-after-drain"),
    ("park-wakeup-lost", "deadlock"),
    ("cow-write-through", "cow-write-through-shared"),
    ("cow-skips-scale", "stale-scale-on-realloc"),
    ("ctrl-recovery-dropped", "controller-wedged"),
])
def test_mutation_found_and_replays(mutation, expect_invariant):
    name = S.MUTATIONS[mutation]
    ex, res = _explore(name, mutation=mutation, max_schedules=10_000)
    assert res.violation is not None, \
        f"{mutation}: not found within 10k schedules"
    assert res.schedules < 10_000
    assert res.violation.invariant == expect_invariant
    small = ex.minimize(res.violation)
    assert len(small.schedule) <= len(res.violation.schedule)
    replayed = ex.replay(small.schedule)
    assert replayed is not None and replayed.invariant == expect_invariant


# ---------------------------------------------------------------------------
# parity with the reference's Explorer
# ---------------------------------------------------------------------------


def test_same_scenarios_and_mutations():
    assert list(S.SCENARIOS) == list(RS.SCENARIOS)
    assert S.MUTATIONS == RS.MUTATIONS
    for name, sc in S.SCENARIOS.items():
        ref = RS.SCENARIOS[name]
        assert (sc.n_threads, sc.max_schedules, sc.max_steps) == \
            (ref.n_threads, ref.max_schedules, ref.max_steps)


def _unnumbered(text):
    """A trace with BRAVO's header cells unnumbered: a cell is named
    ``bravo<id>.hdr`` from the process-wide lock counter before the scenario
    pins the lock's value, so the number counts the locks each package made
    earlier in the process, not anything of the schedule."""
    return re.sub(r"\bbravo\d+\.", "bravo#.", text)


def _summary(res):
    return (res.schedules, res.complete, res.pruned, res.budget_hits,
            None if res.violation is None else res.violation.invariant)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(S.SCENARIOS))
def test_clean_exploration_equals_reference(name, seed):
    _, got = _explore(name, max_schedules=200, seed=seed)
    _, want = _explore(name, max_schedules=200, seed=seed, scenarios=RS,
                       explorer=RC.Explorer)
    assert _summary(got) == _summary(want)
    assert got.violation is None


@pytest.mark.parametrize("mutation", sorted(S.MUTATIONS))
def test_mutation_trace_equals_reference(mutation):
    name = S.MUTATIONS[mutation]
    ex, got = _explore(name, mutation=mutation, max_schedules=10_000)
    rex, want = _explore(name, mutation=mutation, max_schedules=10_000,
                         scenarios=RS, explorer=RC.Explorer)
    assert _summary(got) == _summary(want)
    assert got.violation.schedule == want.violation.schedule
    small, rsmall = ex.minimize(got.violation), rex.minimize(want.violation)
    assert small.schedule == rsmall.schedule
    assert _unnumbered(format_trace(small)) == \
        _unnumbered(RC.format_trace(rsmall))
    assert [_unnumbered(str(e)) for e in small.events] == \
        [_unnumbered(str(e)) for e in rsmall.events]
    assert [e.vc for e in small.events] == [e.vc for e in rsmall.events]


# ---------------------------------------------------------------------------
# backend-agnostic build contract: same programs run under SimMem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(S.SCENARIOS))
def test_scenarios_run_under_simmem(name):
    sc = S.SCENARIOS[name]
    mem = SimMem(sc.n_threads, Topology(2, 2, 2))
    inst = sc.build(mem, None)
    mem.run_threads(inst.threads)
    if inst.at_end is not None:
        inst.at_end()                      # quiescence invariants hold
