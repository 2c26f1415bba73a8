"""Construction helpers: build any lock variant by name.

Names mirror the paper's figures: ``ba``, ``bravo-ba``, ``pthread``,
``bravo-pthread``, ``pf-t``, ``bravo-pf-t``, ``percpu``, ``cohort-rw``.
"""

from __future__ import annotations

from typing import Optional

from .atomics import LiveMem, Mem
from .bravo import BRAVO, DEFAULT_N
from .rwlocks import (CentralCounterRWLock, CohortRWLock, PerCPULock, PFQLock,
                      PFTLock, RWLock)
from .table import DEFAULT_TABLE_SIZE, VisibleReadersTable

__all__ = ["LockEnv", "ALL_LOCK_NAMES", "PAPER_LOCK_NAMES"]

ALL_LOCK_NAMES = (
    "pthread", "bravo-pthread",
    "pf-t", "bravo-pf-t",
    "ba", "bravo-ba",
    "percpu", "cohort-rw",
)
# the headline set plotted in most paper figures
PAPER_LOCK_NAMES = ("ba", "bravo-ba", "pthread", "bravo-pthread",
                    "percpu", "cohort-rw")


class LockEnv:
    """An address space: one memory backend + one shared visible-readers
    table, from which any number of locks can be built (paper §3: the table
    is shared by all locks and threads in the address space)."""

    def __init__(self, mem: Optional[Mem] = None,
                 table_size: int = DEFAULT_TABLE_SIZE, n: int = DEFAULT_N):
        self.mem = mem if mem is not None else LiveMem()
        self.table = VisibleReadersTable(self.mem, table_size)
        self.n = n

    def make(self, name: str, **kw) -> RWLock:
        if name.startswith("bravo-"):
            table = kw.pop("table", self.table)
            return BRAVO(self.make(name[len("bravo-"):], **kw), table,
                         self.mem, n=kw.pop("n", self.n))
        if name == "pthread":
            return CentralCounterRWLock(self.mem)
        if name == "pf-t":
            return PFTLock(self.mem)
        if name == "ba":
            return PFQLock(self.mem)
        if name == "percpu":
            return PerCPULock(self.mem, **kw)
        if name == "cohort-rw":
            return CohortRWLock(self.mem, **kw)
        raise ValueError(f"unknown lock {name!r}")
