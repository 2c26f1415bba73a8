"""Shared pass/fail plumbing for the kernel-vs-plain smoke gates.

Both ``repro_torch.benchmarks.device_bravo`` and
``repro_torch.benchmarks.registry`` exit nonzero on any mismatch; the
check/timeit helpers live here once so the gate semantics cannot drift
between them.
"""

from __future__ import annotations

import time
from typing import Callable, List

FAILURES: List[str] = []


def check(ok: bool, what: str) -> None:
    status = "ok" if ok else "MISMATCH"
    print(f"[{status}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def timeit(fn: Callable[[], object], iters: int) -> float:
    """Mean wall-clock seconds per call (fn must block on completion: a
    call on the card synchronizes it before returning)."""
    fn()                                 # warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------------------
# The card's side of the gates: synchronization, the sync gate, in-place
# ---------------------------------------------------------------------------


def sync(dev) -> None:
    """Wait for the card (a no-op on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_gate(dev, fn: Callable[[], object]) -> str:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises on any host-device synchronization (a copy either way, a read
    of a device value): the analogue of ``jax.transfer_guard("disallow")``.
    -> "passed", "tripped", or "inactive" on the CPU, where host and
    device are one and nothing can be gated."""
    import torch

    if dev.type != "cuda":
        return "inactive"
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        print(f"  sync gate tripped: {e}", flush=True)
        return "tripped"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    return "passed"


def in_place(dev, table_of: Callable[[], object], pair: Callable[[], None],
             pairs: int = 100) -> dict:
    """The torch form of ``repro``'s aliasing proof: the table tensor keeps
    its storage across ``pairs`` acquire/release pairs, and on the card
    ``torch.cuda.memory_allocated()`` does not grow over them."""
    import torch

    pair()                                          # warm-up
    sync(dev)
    ptr = table_of().data_ptr()
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    for _ in range(pairs):
        pair()
    sync(dev)
    growth = (torch.cuda.memory_allocated(dev) - before
              if before is not None else None)
    same = table_of().data_ptr() == ptr
    check(same, f"table storage unchanged over {pairs} pairs")
    if growth is not None:
        check(growth <= 0, f"device memory did not grow over {pairs} pairs "
                           f"({growth} B)")
    return {"pairs": pairs, "table_ptr_unchanged": same,
            "memory_growth_bytes": growth,
            "memory_check": "active" if growth is not None else "inactive"}
