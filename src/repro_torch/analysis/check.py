"""Entry point for the port's static-analysis layer: ``python -m
repro_torch.analysis.check``.

Runs, in order:

1. **Source lint** (:mod:`.lint_src`) — AST layering rules over
   ``src/repro_torch``, PyTorch's host syncs included, filtered through
   ``analysis/lint_allowlist.txt`` (``rule path-substring
   message-substring`` per line).
2. **Lowered-step lint** — ``repro``'s stage 2 reads the XLA HLO of each
   jitted serving step.  PyTorch lowers to no HLO, so the stage has no
   counterpart here; the run says so in one line.  Its transfer rule (no
   host<->device traffic while a lease is held) is held on the card by
   the sync gates of ``chip_smoke.py`` (``torch.cuda.set_sync_debug_mode
   ("error")`` around the lease pair and a replayed decode tick).
3. **Protocol checker** (:mod:`.checker` over :mod:`.scenarios`) —
   bounded systematic exploration of the BRAVO / registry / KV-pool
   scenarios; any interleaving that breaks a declared invariant fails
   the run with a minimal replayable schedule trace.

Exit status 0 = clean; 1 = findings/violations.  ``--mutation NAME``
inverts stage 3 for one seeded bug: the run fails unless the checker
*finds* the planted violation and its minimized schedule replays.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import scenarios as S
from .checker import Explorer, format_trace
from .lint_src import apply_allowlist, lint_tree, load_allowlist

ALLOWLIST = os.path.join(os.path.dirname(__file__), "lint_allowlist.txt")
NO_HLO = ("[2/3] lowered-step lint: no PyTorch counterpart (it reads XLA "
          "HLO); its transfer rule is held on the card by chip_smoke.py's "
          "sync gates")


def run_src_lint(verbose: bool) -> int:
    findings = apply_allowlist(lint_tree(), load_allowlist(ALLOWLIST))
    for f in findings:
        print(f"  FAIL {f}")
    if verbose and not findings:
        print("  source lint clean")
    return len(findings)


def run_checker(names, max_schedules, seed, mutation, verbose) -> int:
    failures = 0
    for name in names:
        sc = S.SCENARIOS[name]
        ex = Explorer(lambda mem: sc.build(mem, mutation), name=name,
                      max_schedules=max_schedules or sc.max_schedules,
                      max_steps=sc.max_steps, seed=seed)
        t0 = time.time()
        res = ex.explore()
        dt = time.time() - t0
        status = "complete" if res.complete else "bounded"
        if res.violation is None:
            if mutation:
                print(f"  FAIL {name}: planted mutation '{mutation}' NOT "
                      f"found in {res.schedules} schedules ({status})")
                failures += 1
            elif verbose:
                print(f"  {name}: no violation in {res.schedules} schedules "
                      f"({status}, {dt:.1f}s)")
            continue
        v = ex.minimize(res.violation)
        replayed = ex.replay(v.schedule)
        ok_replay = (replayed is not None
                     and replayed.invariant == v.invariant)
        if mutation:
            if ok_replay:
                print(f"  {name}: mutation '{mutation}' -> "
                      f"{v.invariant} after {res.schedules} schedules; "
                      f"minimal schedule ({len(v.schedule)} choices) "
                      f"replays ({dt:.1f}s)")
                if verbose:
                    print(format_trace(v))
            else:
                print(f"  FAIL {name}: found {v.invariant} but minimized "
                      f"schedule does not replay")
                failures += 1
        else:
            print(f"  FAIL {name}: {v.invariant} after {res.schedules} "
                  f"schedules (replay={'ok' if ok_replay else 'BROKEN'})")
            print(format_trace(v))
            failures += 1
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="protocol checker + source lint")
    ap.add_argument("--skip-src", action="store_true")
    ap.add_argument("--skip-checker", action="store_true")
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME", help="run only this checker scenario "
                    "(repeatable); default: all")
    ap.add_argument("--max-schedules", type=int, default=None,
                    help="override per-scenario schedule budget")
    ap.add_argument("--seed", type=int, default=0,
                    help="shuffle DFS branch order (0 = deterministic "
                    "run-to-completion-first)")
    ap.add_argument("--mutation", choices=sorted(S.MUTATIONS),
                    help="enable one seeded bug and require the checker "
                    "to find it (runs only that mutation's scenario)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    failures = 0
    if not args.skip_src:
        print("[1/3] source lint (src/repro_torch)")
        failures += run_src_lint(args.verbose)
    else:
        print("[1/3] source lint skipped")

    print(NO_HLO)

    if not args.skip_checker:
        if args.mutation:
            names = [S.MUTATIONS[args.mutation]]
        else:
            names = args.scenario or list(S.SCENARIOS)
        unknown = [n for n in names if n not in S.SCENARIOS]
        if unknown:
            ap.error(f"unknown scenario(s): {unknown}; "
                     f"have {sorted(S.SCENARIOS)}")
        print(f"[3/3] protocol checker ({', '.join(names)})")
        failures += run_checker(names, args.max_schedules, args.seed,
                                args.mutation, args.verbose)
    else:
        print("[3/3] protocol checker skipped")

    print("analysis: " + ("OK" if failures == 0
                          else f"{failures} failure(s)"))
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
