"""Typed metric registry: counters, gauges, fixed-bucket histograms.

Copied unchanged from ``repro.obs.metrics`` so the port imports nothing of the
reference package.

The measured counterpart of the paper's *derived* performance ledger
(``core/opcount.py`` reproduces Table 2's adder/shifter counts; this
module measures what the running system actually does): dispatch
decisions, degrade events, cache hits, codec throughput, serve latency.
DESIGN.md §15.

Three metric kinds, Prometheus-shaped on purpose:

  * :class:`Counter`  — monotonically increasing float (``inc``).
  * :class:`Gauge`    — a settable point-in-time value (``set``/``add``).
  * :class:`Histogram` — fixed-bucket distribution with cumulative
    bucket counts, ``sum``/``count``, and bucketed quantile estimates
    (p50/p95/p99 by default).  Buckets are fixed at construction so
    ``observe`` is one bisect + one add — cheap enough to leave on.

All metrics hang off a :class:`MetricRegistry`; ``get_or_create``
semantics mean instrumentation sites never coordinate — the first
caller creates, everyone else increments the same object.  Metrics are
named ``subsystem.metric`` with optional label pairs; a (name, labels)
pair identifies exactly one time series, exactly like the Prometheus
data model.

Thread safety: every mutation takes the registry's lock (one process-
wide lock, not per-metric — the contended sites are host-side and
microseconds apart, and one lock keeps ``snapshot`` consistent).  The
serve retry path exercises counters from worker threads; the tier-1
suite hammers this concurrently.

This module is stdlib-only (no torch, no numpy): the registry must be
importable from the same layers as ``benchmarks/gate.py`` and the
resilience taxonomy.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs import _state

LabelPairs = Tuple[Tuple[str, str], ...]


def _labelkey(labels: Dict[str, str]) -> LabelPairs:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(labels: LabelPairs) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotonic counter.  ``inc`` only; never decreases, never resets
    except through ``MetricRegistry.reset`` (tests)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: LabelPairs, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not _state.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name}: inc({amount}) < 0")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value.  ``set`` replaces, ``add`` adjusts (either
    sign) — queue depths, hit rates, ratios."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: LabelPairs, lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._lock = lock
        self._value = 0.0

    def set(self, value: float) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        if not _state.enabled:
            return
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


# default histogram buckets: log-spaced upper bounds covering microseconds
# to minutes when observations are in milliseconds (or bytes to gigabytes
# when they are byte counts) — 2 buckets per decade over 12 decades
_DEFAULT_BUCKETS = tuple(
    round(m * 10.0 ** e, 6) for e in range(-3, 9) for m in (1.0, 3.0)
)

DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


class Histogram:
    """Fixed-bucket histogram with bucketed quantile estimates.

    ``buckets`` are the finite upper bounds (ascending); an implicit
    +inf bucket catches everything beyond the last bound.  ``observe``
    is a bisect plus three adds under the lock — no allocation, no
    device work, cheap enough for per-request serve paths.

    Quantiles are *bucketed estimates*: :meth:`quantile` interpolates
    linearly inside the bucket holding the q-th observation, and
    :meth:`quantile_bounds` returns that bucket's (lo, hi] bounds — the
    exact sample quantile provably lies inside them (the property the
    tier-1 suite checks against numpy percentiles on adversarial
    distributions).
    """

    __slots__ = ("name", "labels", "_lock", "buckets", "_counts", "_sum",
                 "_count", "_min", "_max")

    def __init__(
        self,
        name: str,
        labels: LabelPairs,
        lock: threading.Lock,
        buckets: Sequence[float] = _DEFAULT_BUCKETS,
    ):
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"histogram {name}: buckets must ascend, got {bs}")
        self.name = name
        self.labels = labels
        self._lock = lock
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # +1: the +inf bucket
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        if not _state.enabled:
            return
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def _quantile_bucket(self, q: float) -> Tuple[int, int, int]:
        """(bucket index, cumulative count below it, rank) for quantile q."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        # rank of the q-th observation, 1-based nearest-rank
        rank = max(1, math.ceil(q * self._count))
        cum = 0
        for i, c in enumerate(self._counts):
            if cum + c >= rank:
                return i, cum, rank
            cum += c
        return len(self._counts) - 1, cum, rank  # unreachable with count>0

    def quantile_bounds(self, q: float) -> Tuple[float, float]:
        """The (lo, hi] bounds of the bucket holding the q-th observation.

        The exact sample quantile lies inside these bounds by
        construction; the lowest bucket's lo is the observed minimum and
        the +inf bucket's hi is the observed maximum, so the bounds are
        always finite once anything was observed.
        """
        if self._count == 0:
            return (0.0, 0.0)
        i, _, _ = self._quantile_bucket(q)
        lo = self.buckets[i - 1] if i > 0 else min(self._min, self.buckets[0])
        hi = self.buckets[i] if i < len(self.buckets) else self._max
        # the q-th observation can also never leave the observed range
        return (max(lo, self._min), min(max(hi, self._min), self._max))

    def quantile(self, q: float) -> float:
        """Bucketed quantile estimate: linear interpolation inside the
        bucket holding the q-th observation (0 when nothing observed)."""
        if self._count == 0:
            return 0.0
        i, below, rank = self._quantile_bucket(q)
        lo, hi = self.quantile_bounds(q)
        in_bucket = self._counts[i]
        if in_bucket <= 1 or hi <= lo:
            return hi
        frac = (rank - below) / in_bucket
        return lo + (hi - lo) * frac

    def summary(self, quantiles: Iterable[float] = DEFAULT_QUANTILES) -> Dict:
        out = {
            "count": self._count,
            "sum": round(self._sum, 6),
            "mean": round(self.mean(), 6),
        }
        if self._count:
            out["min"] = round(self._min, 6)
            out["max"] = round(self._max, 6)
        for q in quantiles:
            out[f"p{round(q * 100) if q * 100 == int(q * 100) else q * 100:g}"] = (
                round(self.quantile(q), 6)
            )
        return out


class MetricRegistry:
    """Process-wide named metrics with get-or-create semantics.

    One series per (name, labels); asking for an existing name with a
    different metric kind is a programming error and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelPairs], object] = {}

    def _get_or_create(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _labelkey(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], self._lock, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name}{dict(key[1])} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(
        self, name: str, buckets: Optional[Sequence[float]] = None,
        **labels: str,
    ) -> Histogram:
        kw = {} if buckets is None else {"buckets": tuple(buckets)}
        return self._get_or_create(Histogram, name, labels, **kw)

    # -- read side ----------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Every series as plain dict/float values, keyed
        ``name{label="v"}`` (bare ``name`` when unlabelled)."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for (name, labels), m in items:
            key = name + _fmt_labels(labels)
            if isinstance(m, Histogram):
                out[key] = m.summary()
            else:
                out[key] = m.value
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4) of every series."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
        lines: List[str] = []
        seen_type = set()
        for (name, labels), m in items:
            pname = name.replace(".", "_").replace("-", "_")
            if isinstance(m, Counter):
                if pname not in seen_type:
                    lines.append(f"# TYPE {pname} counter")
                    seen_type.add(pname)
                lines.append(f"{pname}{_fmt_labels(labels)} {m.value:g}")
            elif isinstance(m, Gauge):
                if pname not in seen_type:
                    lines.append(f"# TYPE {pname} gauge")
                    seen_type.add(pname)
                lines.append(f"{pname}{_fmt_labels(labels)} {m.value:g}")
            elif isinstance(m, Histogram):
                if pname not in seen_type:
                    lines.append(f"# TYPE {pname} histogram")
                    seen_type.add(pname)
                cum = 0
                for ub, c in zip(m.buckets, m._counts):
                    cum += c
                    le = dict(labels)
                    le["le"] = f"{ub:g}"
                    lines.append(
                        f"{pname}_bucket{_fmt_labels(_labelkey(le))} {cum}"
                    )
                le = dict(labels)
                le["le"] = "+Inf"
                lines.append(
                    f"{pname}_bucket{_fmt_labels(_labelkey(le))} {m.count}"
                )
                lines.append(f"{pname}_sum{_fmt_labels(labels)} {m.sum:g}")
                lines.append(f"{pname}_count{_fmt_labels(labels)} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every series (tests and the overhead bench only)."""
        with self._lock:
            self._metrics.clear()
