"""Straggler and failure detection for the multi-host control plane.

Hosts report per-step heartbeats (step index + duration).  The detector's
state is read by every reporting thread (read-dominated, BRAVO-guarded) and
written only when membership changes.  Policy outputs:

* straggler: a host whose EWMA step time exceeds ``slow_factor`` x the
  cluster median -> flagged; the launcher's response is to exclude the host
  at the next elastic restart (tested with simulated hosts).
* dead: no heartbeat within ``timeout_s`` -> triggers checkpoint restore on
  the surviving membership (see examples/elastic_restart.py).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.factory import LockEnv


@dataclasses.dataclass
class HostState:
    last_beat: float = 0.0
    ewma_ms: float = 0.0
    steps: int = 0


class StragglerDetector:
    def __init__(self, hosts: int, *, slow_factor: float = 2.0,
                 timeout_s: float = 10.0, alpha: float = 0.2,
                 env: Optional[LockEnv] = None,
                 lock_name: str = "bravo-ba",
                 clock=time.monotonic):
        self.env = env or LockEnv()
        self.lock = self.env.make(lock_name)
        self.hosts: Dict[int, HostState] = {h: HostState() for h in
                                            range(hosts)}
        self.slow_factor = slow_factor
        self.timeout_s = timeout_s
        self.alpha = alpha
        self.clock = clock

    def heartbeat(self, host: int, step_ms: float) -> None:
        tok = self.lock.acquire_read()   # per-host slot: read-shared state
        try:
            st = self.hosts[host]
        finally:
            self.lock.release_read(tok)
        st.last_beat = self.clock()
        st.ewma_ms = step_ms if st.steps == 0 else \
            (1 - self.alpha) * st.ewma_ms + self.alpha * step_ms
        st.steps += 1

    def snapshot(self) -> Dict[str, List[int]]:
        tok = self.lock.acquire_read()
        try:
            hosts = dict(self.hosts)
        finally:
            self.lock.release_read(tok)
        now = self.clock()
        ew = [s.ewma_ms for s in hosts.values() if s.steps > 0]
        med = float(np.median(ew)) if ew else 0.0
        stragglers = [h for h, s in hosts.items()
                      if s.steps > 0 and med > 0
                      and s.ewma_ms > self.slow_factor * med]
        dead = [h for h, s in hosts.items()
                if s.last_beat and now - s.last_beat > self.timeout_s]
        return {"stragglers": stragglers, "dead": dead,
                "median_ms": [int(med)]}

    def remove(self, host: int) -> None:
        tok = self.lock.acquire_write()
        try:
            self.hosts.pop(host, None)
        finally:
            self.lock.release_write(tok)

    def add(self, host: int) -> None:
        tok = self.lock.acquire_write()
        try:
            self.hosts[host] = HostState()
        finally:
            self.lock.release_write(tok)
