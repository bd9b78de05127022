"""Structured event log: typed, ring-buffered, queryable.

Copied from ``repro.obs.events`` so the port imports nothing of the
reference package; the reference's ``DispatchEvent``, which nothing in
the port emits, is left out.

Before this module, the system's notable runtime transitions — a kernel
degrading off Pallas, a serve batch retrying, a checkpoint band healing
from parity — surfaced as once-per-process warnings or not at all.  The
event log makes them *data*: every occurrence appends a typed dataclass
to a bounded ring buffer (``collections.deque(maxlen=...)`` — O(1),
never grows), and operators query by type / subsystem / label instead
of grepping logs.  Warning sites keep their warnings (categories and
once-per-key dedupe unchanged — CI's ``-W error::RuntimeWarning``
behaviour is preserved); they *also* emit here, so the Nth occurrence
is never lost.  DESIGN.md §15.

Event taxonomy (one dataclass per transition kind):

  * :class:`DegradeEvent`   — a slower-but-correct path took over
  * :class:`FaultEvent`     — a typed failure surfaced (error raised or
    attached to a request)
  * :class:`HealEvent`      — damage reconstructed bit-exactly (parity
    heal, retry-then-succeed)
  * :class:`AdmissionEvent` — a serve admission outcome (admitted /
    shed / deadline-expired)
  * :class:`RetryEvent`     — a bounded-retry attempt fired

Timestamps are ``time.monotonic()`` (ordering/arithmetic-safe) plus a
``wall`` epoch stamp for correlation with external logs.  Stdlib-only,
like the metrics registry.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Type

from repro_torch.obs import _state

DEFAULT_CAPACITY = 4096


@dataclasses.dataclass
class Event:
    """Base event: subsystem + human detail + monotonic/wall stamps.

    ``ts`` / ``wall`` are stamped at construction; pass them only when
    replaying recorded events.
    """

    subsystem: str  # "kernels" | "codec" | "serve" | "ckpt" | "collectives"
    detail: str = ""
    ts: float = dataclasses.field(default_factory=time.monotonic)
    wall: float = dataclasses.field(default_factory=time.time)

    @property
    def kind(self) -> str:
        return type(self).__name__

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind
        return d


@dataclasses.dataclass
class DegradeEvent(Event):
    """A slower-but-correct path took over (batch -> per-request
    encode, ...).  Emitted on EVERY occurrence — the paired
    warning stays once-per-key."""

    requested: str = ""
    resolved: str = ""
    reason: str = ""


@dataclasses.dataclass
class FaultEvent(Event):
    """A typed failure surfaced: the error class name plus where."""

    error: str = ""  # exception class name
    site: str = ""  # inject site / code location label


@dataclasses.dataclass
class HealEvent(Event):
    """Damage reconstructed bit-exactly (parity heal, self-healing
    restore, retry that eventually succeeded)."""

    mechanism: str = ""  # "parity" | "retry" | "requeue" | ...


@dataclasses.dataclass
class AdmissionEvent(Event):
    """A serve admission outcome."""

    outcome: str = ""  # "admitted" | "shed" | "deadline-expired"
    uid: Optional[int] = None
    bucket: str = ""


@dataclasses.dataclass
class RetryEvent(Event):
    """One bounded-retry attempt."""

    attempt: int = 0
    attempts: int = 0
    error: str = ""


EVENT_TYPES = (DegradeEvent, FaultEvent, HealEvent, AdmissionEvent, RetryEvent)


class EventLog:
    """Bounded ring buffer of :class:`Event` objects.

    ``emit`` is deque.append under a lock; when the buffer is full the
    oldest event falls off — the log can never grow a long-running
    process out of memory.  ``total`` keeps counting past the capacity,
    so "how many degrades ever" survives ring wraparound (the metrics
    registry carries the same totals as counters; the log carries the
    *which/why*).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._buf: Deque[Event] = deque(maxlen=capacity)
        self._total = 0

    def emit(self, event: Event) -> Event:
        if not _state.enabled:
            return event
        with self._lock:
            self._buf.append(event)
            self._total += 1
        return event

    @property
    def total(self) -> int:
        """Events ever emitted (not bounded by the ring capacity)."""
        return self._total

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[Event]:
        with self._lock:
            return iter(list(self._buf))

    def query(
        self,
        kind: Optional[Type[Event]] = None,
        subsystem: Optional[str] = None,
        since: Optional[float] = None,
    ) -> List[Event]:
        """Events still in the ring, filtered by type / subsystem /
        monotonic timestamp, oldest first."""
        with self._lock:
            events = list(self._buf)
        return [
            e
            for e in events
            if (kind is None or isinstance(e, kind))
            and (subsystem is None or e.subsystem == subsystem)
            and (since is None or e.ts >= since)
        ]

    def counts(self) -> Dict[str, int]:
        """In-ring event counts by kind name (snapshot/bench payloads)."""
        out: Dict[str, int] = {}
        for e in self:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self._total = 0
