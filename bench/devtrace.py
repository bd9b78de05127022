"""Reduce a ``torch.profiler`` trace of the traced round trips to what the
per-layer metrics and the result's ``breakdown`` read.

The trace records CUDA activity only: the profiler's per-op records of
the host side cost more host time than the port's own dispatch, and
would leave the card idle behind them.  A record is ``(name, start_us,
end_us)``.  Device records are every operation the card ran (kernels,
copies, fills); host records are the CUDA runtime calls.  The traced
window runs from the first device record's start to the last one's end;
the card is busy where any device record runs, and idle in the gaps
between them.  A gap is named by the runtime call the host was in at
its middle ("python" where it was in none: the port's dispatch or the
benchmark's loop) and the device operation that ended it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

Record = Tuple[str, float, float]


@dataclass
class Summary:
    window_s: float  # first device start to last device end
    busy_s: float  # union of device records
    device_op_s: float  # sum of device record durations
    longest_gap_s: float
    device_ops: List[Tuple[str, float]]  # seconds by name, most first (at most 10)
    idle_gaps: List[Tuple[str, float]]  # longest gaps, named by the host's work (at most 10)


def from_profiler(prof) -> Tuple[List[Record], List[Record]]:
    """(device records, host records) of a finished ``torch.profiler.profile``."""
    dev: List[Record] = []
    host: List[Record] = []
    for ev in prof.events():
        rec = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        (dev if str(ev.device_type).endswith("CUDA") else host).append(rec)
    return dev, host


def _merge(recs: Sequence[Record]) -> List[Tuple[float, float]]:
    spans: List[Tuple[float, float]] = []
    for _, a, b in sorted(recs, key=lambda r: r[1]):
        if spans and a <= spans[-1][1]:
            spans[-1] = (spans[-1][0], max(spans[-1][1], b))
        else:
            spans.append((a, b))
    return spans


def _short(name: str) -> str:
    return name.removeprefix("void ").split("(")[0][:80]


def _gap_label(a: float, b: float, nxt: str, host: Sequence[Record]) -> str:
    """What the host was doing in the gap (a, b), and what ended it."""
    mid = (a + b) / 2
    inner = min((r for r in host if r[1] <= mid <= r[2]), key=lambda r: r[2] - r[1], default=None)
    return f"{_short(inner[0]) if inner else 'python'} before {_short(nxt)}"


def summarise(dev: Sequence[Record], host: Sequence[Record]) -> Summary:
    """The traced window's busy and idle time, its longest gaps and its
    heaviest device operations.  Raises when no device record was seen."""
    if not dev:
        raise ValueError("the trace holds no device operation")
    spans = _merge(dev)
    window_us = spans[-1][1] - spans[0][0]
    busy_us = sum(b - a for a, b in spans)
    starts = sorted((r[1], r[0]) for r in dev)
    first_at = {}
    for t, name in starts:
        first_at.setdefault(t, name)
    gaps = sorted(((spans[i][1], spans[i + 1][0], first_at[spans[i + 1][0]])
                   for i in range(len(spans) - 1)), key=lambda g: g[0] - g[1])
    by_name: Dict[str, float] = {}
    for name, a, b in dev:
        by_name[_short(name)] = by_name.get(_short(name), 0.0) + (b - a) / 1e6
    return Summary(
        window_s=window_us / 1e6,
        busy_s=busy_us / 1e6,
        device_op_s=sum(b - a for _, a, b in dev) / 1e6,
        longest_gap_s=(gaps[0][1] - gaps[0][0]) / 1e6 if gaps else 0.0,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=[(_gap_label(a, b, nxt, host), (b - a) / 1e6) for a, b, nxt in gaps[:10]],
    )
