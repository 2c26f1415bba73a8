"""Typed protocol errors.

Guards on the lock/pool protocols used to be bare ``assert``s (stripped
under ``python -O``) or anonymous ``RuntimeError``s.  They are now
:class:`ProtocolError`, which subclasses ``RuntimeError`` so existing
``except RuntimeError`` handlers and tests keep working, and carries the
identifying context (lock id, slot, owner value) in the message.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ProtocolError", "DrainTimeout"]


class ProtocolError(RuntimeError):
    """A lock/pool protocol invariant was violated (or would be).

    Raised by :class:`~repro_torch.core.registry.BravoRegistry` and
    :class:`~repro_torch.serving.kv_pool.KVPool` on handle-lifetime and geometry
    violations, and by the :mod:`repro_torch.analysis.checker` host models when a
    modelled transition is illegal.  Unlike an ``assert`` it survives
    ``python -O``.
    """


class DrainTimeout(ProtocolError, TimeoutError):
    """A bounded revocation drain hit its deadline with leases still held.

    Raised by the writer side of the device lease protocols
    (:func:`~repro_torch.core.device_bravo.revoke`,
    :meth:`~repro_torch.core.registry.BravoRegistry.revoke`,
    :meth:`~repro_torch.core.registry.BravoRegistry.free`) when readers have not
    drained within ``max_wait_s`` — a wedged reader, a dropped revocation
    ack, or a straggling shard.  Subclasses both :class:`ProtocolError`
    (typed protocol failure) and :class:`TimeoutError` (what the old spin
    loops raised), so existing handlers keep working.

    The registry's revoke pairs the raise with a stuck-lane scrub: the
    lane's slots are cleared and its lock VALUE regenerated, so the wedged
    reader's stale publish can never match the lock once callers decide to
    rearm and retry (see ``BravoRegistry._scrub_stuck_lane``).  Callers are
    expected to degrade gracefully — stop admitting, finish in-flight work
    on the old state, retry with backoff — rather than crash; the serving
    engine's ``hot_swap`` does exactly that.

    Attributes carry the identifying context for the degradation path:
    ``lock_id`` (the value readers were publishing), ``idx`` (the bias
    lane, or None off-registry), ``held`` (the last observed lease count)
    and ``waited_s`` (how long the drain ran before giving up).
    """

    def __init__(self, message: str, *, lock_id: Optional[int] = None,
                 idx: Optional[int] = None, held: Optional[int] = None,
                 waited_s: Optional[float] = None):
        super().__init__(message)
        self.lock_id = lock_id
        self.idx = idx
        self.held = held
        self.waited_s = waited_s
