"""Span-based tracing with Chrome-trace export.

A :func:`Tracer.span` context manager records host-side wall time
(``time.perf_counter``) around a region and appends one record to a
bounded ring buffer.  Export is the Chrome trace-event JSON format
(``ph: "X"`` complete events), which loads directly in Perfetto /
``chrome://tracing`` — one lane per thread, spans nest by timestamp.

Two rules keep tracing off the hot device path:

  * Spans never synchronize the device.  A span around a kernel launch
    measures HOST enqueue wall time (CUDA launches return before the
    device finishes) — that is the queue/launch cost, which is what the
    serve tier needs; device-side time belongs to the profiler.
  * Device-side correlation is opt-in: ``device=True`` additionally
    enters ``torch.profiler.record_function(name)``, so when a
    ``torch.profiler`` session is active the span shows up on its
    timeline too.  torch is imported lazily so the stdlib layers can
    import this module without it.

Copied from ``repro.obs.trace``; the device hook is the only change.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional

from repro_torch.obs import _state

DEFAULT_CAPACITY = 8192


class SpanRecord(NamedTuple):
    name: str
    cat: str  # subsystem ("kernels", "codec", "serve", "ckpt", "collectives")
    ts_us: float  # start, microseconds since the tracer's origin
    dur_us: float
    tid: int
    args: Dict[str, object]


def _trace_annotation(name: str):
    """``torch.profiler.record_function`` when torch is importable, else
    a null context — the device-timeline hook for ``span(device=True)``."""
    try:
        from torch.profiler import record_function
    except ImportError:  # stdlib-only callers
        return contextlib.nullcontext()
    return record_function(name)


class Tracer:
    """Bounded ring of completed spans + Chrome-trace export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._spans: Deque[SpanRecord] = deque(maxlen=capacity)
        self._origin = time.perf_counter()
        self._total = 0

    @contextlib.contextmanager
    def span(
        self, name: str, subsystem: str = "", device: bool = False,
        **attrs: object,
    ) -> Iterator[None]:
        """Record host wall time for the enclosed region.

        ``subsystem`` becomes the Chrome-trace category; ``attrs`` land
        in the event's ``args``.  ``device=True`` additionally annotates
        the profiler timeline via ``torch.profiler.record_function``.
        Disabled tracing yields immediately (one flag read).
        """
        if not _state.enabled:
            yield
            return
        dev_ctx = _trace_annotation(name) if device else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with dev_ctx:
                yield
        finally:
            t1 = time.perf_counter()
            rec = SpanRecord(
                name=name,
                cat=subsystem or "repro",
                ts_us=(t0 - self._origin) * 1e6,
                dur_us=(t1 - t0) * 1e6,
                tid=threading.get_ident(),
                args=dict(attrs) if attrs else {},
            )
            with self._lock:
                self._spans.append(rec)
                self._total += 1

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
            s
            for s in out
            if (subsystem is None or s.cat == subsystem)
            and (name is None or s.name == name)
        ]

    def subsystems(self) -> Dict[str, int]:
        """In-ring span counts by subsystem/category."""
        out: Dict[str, int] = {}
        for s in self.spans():
            out[s.cat] = out.get(s.cat, 0) + 1
        return out

    def export_chrome_trace(self) -> Dict:
        """The trace as a Chrome trace-event dict (Perfetto-loadable).

        ``ph: "X"`` complete events, microsecond timestamps, one lane
        per recording thread.
        """
        pid = os.getpid()
        events = [
            {
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": round(s.ts_us, 3),
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
            self._origin = time.perf_counter()
