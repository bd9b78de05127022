"""Span-based tracing on the profiler's clock, with Chrome-trace export.

A span records host wall time around a region and appends one record to
a bounded ring buffer.  Its start and end are Unix nanoseconds, the time
base of ``torch.profiler``'s kineto events (``start_ns()``,
``trace_start_ns()``): ``time.perf_counter_ns`` plus one offset to
``time.time_ns``, read when the tracer's origin is set, so a step of the
wall clock cannot tear a span.  Subtracting a profile's
``trace_start_ns()`` lays a span on that profile's timeline, device
records and CUDA runtime calls included.  Export is the Chrome
trace-event JSON format (``ph: "X"`` complete events, ``ts`` relative to
the origin), which loads in Perfetto / ``chrome://tracing``: one lane per
thread, spans nest by timestamp.

Two switches decide whether a span records:

  * ``serve``, ``codec``, ``ckpt`` and ``collectives`` spans
    (:meth:`Tracer.span`) record while ``_state.enabled`` is on
    (``REPRO_OBS``, ``set_enabled``);
  * the kernels layer's spans sit on the launch path, so they record only
    inside ``obs.tracing("kernels")``.  Their sites read ``_state.kernels``
    and enter :data:`NULL` when it is off, so an untraced call pays one
    flag read a site and allocates nothing::

        with tracer.record("kernels.level", "kernels", level=1) if _state.kernels else NULL:
            ...

Spans never synchronize the device.  A span around a kernel launch
measures HOST enqueue time (CUDA launches return before the device
finishes); device time belongs to the profiler's trace, which the shared
clock lines the spans up with.

Copied from ``repro.obs.trace``; the clock, the kernels switch and the
span objects are the port's.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional

from repro_torch.obs import _state

DEFAULT_CAPACITY = 8192

# what a span site enters when its switch is off: shared, never allocated again
NULL = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    name: str
    cat: str  # subsystem ("kernels", "codec", "serve", "ckpt", "collectives")
    start_ns: int  # Unix nanoseconds, the profiler's time base
    end_ns: int
    tid: int
    args: Dict[str, object]

    @property
    def dur_us(self) -> float:
        return (self.end_ns - self.start_ns) / 1e3


def unix_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of
    16 wall-clock reads bracketed by two ``perf_counter_ns`` reads (a read
    held up between its brackets would shift every span by the delay)."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class _Span:
    """One open span: the start on entry, one record on exit (also when
    the region raises)."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict[str, object]):
        self._tracer, self._name, self._cat, self._args = tracer, name, cat, args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        tracer = self._tracer
        off = tracer._offset_ns
        # a plain tuple (a SpanRecord on the read side): the recording path
        # is on the launch path when the kernels layer is traced
        rec = (self._name, self._cat, self._t0 + off, t1 + off, threading.get_ident(), self._args)
        with tracer._lock:
            tracer._spans.append(rec)
            tracer._total += 1
        return False


class Tracer:
    """Bounded ring of completed spans + Chrome-trace export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._spans: Deque[tuple] = deque(maxlen=capacity)
        self._total = 0
        self._set_origin()

    def _set_origin(self) -> None:
        self._offset_ns = unix_offset_ns()
        self.origin_ns = time.perf_counter_ns() + self._offset_ns  # Unix ns

    def span(self, name: str, subsystem: str = "", **attrs: object):
        """Record host wall time for the enclosed region, while
        instrumentation is enabled (``REPRO_OBS`` / ``set_enabled``);
        otherwise :data:`NULL` (one flag read).

        ``subsystem`` becomes the Chrome-trace category; ``attrs`` land
        in the event's ``args``.
        """
        if not _state.enabled:
            return NULL
        return _Span(self, name, subsystem or "repro", attrs)

    def record(self, name: str, subsystem: str, **attrs: object) -> _Span:
        """A span that records regardless of ``_state.enabled``: for sites
        behind a switch of their own (the kernels layer's
        ``_state.kernels``, set by ``obs.tracing("kernels")``)."""
        return _Span(self, name, subsystem, attrs)

    # -- read side ----------------------------------------------------------

    @property
    def total(self) -> int:
        """Spans ever recorded (not bounded by the ring capacity)."""
        return self._total

    def __len__(self) -> int:
        return len(self._spans)

    def spans(
        self, subsystem: Optional[str] = None, name: Optional[str] = None
    ) -> List[SpanRecord]:
        with self._lock:
            out = list(self._spans)
        return [
            SpanRecord._make(s)
            for s in out
            if (subsystem is None or s[1] == subsystem)
            and (name is None or s[0] == name)
        ]

    def subsystems(self) -> Dict[str, int]:
        """In-ring span counts by subsystem/category."""
        out: Dict[str, int] = {}
        for s in self.spans():
            out[s.cat] = out.get(s.cat, 0) + 1
        return out

    def export_chrome_trace(self) -> Dict:
        """The trace as a Chrome trace-event dict (Perfetto-loadable).

        ``ph: "X"`` complete events, microseconds from the tracer's
        origin, one lane per recording thread.
        """
        pid = os.getpid()
        events = [
            {
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": round((s.start_ns - self.origin_ns) / 1e3, 3),
                "dur": round(s.dur_us, 3),
                "pid": pid,
                "tid": s.tid,
                "args": s.args,
            }
            for s in self.spans()
        ]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> str:
        """Serialize :meth:`export_chrome_trace` to ``path``; returns it."""
        payload = json.dumps(self.export_chrome_trace())
        with open(path, "w") as f:
            f.write(payload)
        return str(path)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._total = 0
            self._set_origin()


@contextlib.contextmanager
def tracing(subsystem: str):
    """Scope in which the spans of ``subsystem`` record.  Only the kernels
    layer is scoped this way (``"kernels"``: ``kernels.call``,
    ``kernels.level``, ``kernels.launch``); its flag is process-wide, so
    every thread's kernels calls record inside the scope.  The other
    subsystems follow ``REPRO_OBS`` / ``set_enabled``."""
    if subsystem != "kernels":
        raise ValueError(f"only the kernels layer's spans are scoped, got {subsystem!r}")
    prev = _state.kernels
    _state.kernels = True
    try:
        yield
    finally:
        _state.kernels = prev
