"""``repro_torch.obs`` — process-wide observability for the port.

A copy of ``repro.obs`` (stdlib-only), kept separate so the port never
imports the reference package.  The measurement substrate under the
kernels and serve layers:

    metrics.py  typed metric registry — counters, gauges, fixed-bucket
                histograms with p50/p95/p99 estimates; ``snapshot()``
                dict API + Prometheus text exposition
    events.py   structured event log — typed dataclasses (Dispatch /
                Degrade / Fault / Heal / Admission / Retry) in a bounded
                ring buffer; warning sites ALSO emit here, so the Nth
                degrade is queryable even though the warning fired once
    trace.py    span-based tracing — host-side wall time per region,
                optional ``torch.profiler.record_function`` hook,
                Chrome-trace JSON export (loads in Perfetto)

One process-wide instance of each lives here; instrumentation sites use
the module-level helpers::

    from repro_torch import obs
    obs.counter("serve.requests_admitted").inc()
    obs.histogram("serve.batch_latency_ms").observe(ms)
    obs.emit(obs.FaultEvent(subsystem="serve", error="InjectedFault",
                            site="serve.transform"))
    with obs.span("serve.step", subsystem="serve", bucket="256x256"):
        ...

Everything is host-side and allocation-light: no sync points, nothing
inside kernels, one flag read on the disabled path
(``REPRO_OBS=0`` / :func:`set_enabled`).

Metric names are ``subsystem.metric`` (subsystems so far: ``kernels``
and ``serve``); :func:`subsystems` derives the live set from the
snapshot.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

from repro_torch.obs import _state
from repro_torch.obs.events import (  # noqa: F401
    EVENT_TYPES,
    AdmissionEvent,
    DegradeEvent,
    DispatchEvent,
    Event,
    EventLog,
    FaultEvent,
    HealEvent,
    RetryEvent,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
)
from repro_torch.obs.trace import SpanRecord, Tracer  # noqa: F401

# the process-wide instances every subsystem instruments against
registry = MetricRegistry()
events = EventLog()
tracer = Tracer()

# bound helpers: obs.counter(...), obs.emit(...), obs.span(...)
counter = registry.counter
gauge = registry.gauge
histogram = registry.histogram
emit = events.emit
span = tracer.span

set_enabled = _state.set_enabled
is_enabled = _state.is_enabled


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Scope with instrumentation off (the overhead bench's bare arm)."""
    prev = _state.enabled
    _state.set_enabled(False)
    try:
        yield
    finally:
        _state.set_enabled(prev)


def snapshot() -> Dict:
    """One dict with everything: every metric series, in-ring event
    counts (plus the unbounded total), and per-subsystem span counts."""
    return {
        "metrics": registry.snapshot(),
        "events": {"total": events.total, "counts": events.counts()},
        "spans": {"total": tracer.total, "subsystems": tracer.subsystems()},
    }


def subsystems() -> set:
    """Subsystem prefixes with at least one live metric series."""
    return {
        name.split(".", 1)[0]
        for name in registry.snapshot()
        if "." in name
    }


def render_prometheus() -> str:
    """Prometheus text exposition of the process-wide registry."""
    return registry.render_prometheus()


def export_chrome_trace() -> Dict:
    """The process-wide tracer as a Chrome trace-event dict."""
    return tracer.export_chrome_trace()


def write_chrome_trace(path) -> str:
    """Write the Chrome-trace JSON to ``path``; returns the path."""
    return tracer.write_chrome_trace(path)


def reset() -> None:
    """Clear every metric, event, and span (tests + the overhead bench)."""
    registry.reset()
    events.reset()
    tracer.reset()


def warn_event(event: Event, warning: Warning, stacklevel: int = 3) -> None:
    """Emit a structured event AND the legacy warning in one call.

    The consolidation shim for pre-obs warning sites: the warning keeps
    its category (so ``-W error::RuntimeWarning`` CI filters behave
    exactly as before) while every occurrence also lands in the event
    log.  ``stacklevel`` counts from the caller's caller, matching a
    direct ``warnings.warn`` at the call site.
    """
    import warnings

    emit(event)
    warnings.warn(warning, stacklevel=stacklevel + 1)


__all__ = [
    "AdmissionEvent",
    "Counter",
    "DegradeEvent",
    "DispatchEvent",
    "Event",
    "EventLog",
    "EVENT_TYPES",
    "FaultEvent",
    "Gauge",
    "HealEvent",
    "Histogram",
    "MetricRegistry",
    "RetryEvent",
    "SpanRecord",
    "Tracer",
    "counter",
    "disabled",
    "emit",
    "events",
    "export_chrome_trace",
    "gauge",
    "histogram",
    "is_enabled",
    "registry",
    "render_prometheus",
    "reset",
    "set_enabled",
    "snapshot",
    "span",
    "subsystems",
    "tracer",
    "warn_event",
    "write_chrome_trace",
]
