"""Cache of transform callables for the wavelet serve tier.

Port of ``repro.serve.executor``.  Every ``(bucket, batch_slots, scheme,
levels, mode, device)`` combination the engine can emit maps to exactly
one callable, built on first use and reused for the life of the engine.
PyTorch runs eagerly, so a callable is the level chain of
``kernels.dwt_fwd_2d_multi`` bound to its key — there is no ``jax.jit``
to trace and no donated input buffer; what the cache still pins is that
each key is resolved once.  ``hits`` / ``misses`` / ``compiles`` keep
their reference meaning (``compiles`` == distinct callables built).
CUDA-graph capture per key comes in a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

from repro_torch import obs

Shape = Tuple[int, ...]


class ExecKey(NamedTuple):
    """Everything that selects a distinct transform callable."""

    bucket: Shape  # (H, W)
    batch_slots: int
    scheme: str
    levels: int
    mode: str
    device: str  # "cuda" / "cuda:N" / "cpu"


class TransformExecutor:
    """One forward-transform callable per :class:`ExecKey`."""

    def __init__(self):
        self._cache: Dict[ExecKey, Callable] = {}
        self.hits = 0
        self.misses = 0

    @property
    def compiles(self) -> int:
        """Distinct callables built (== cache misses)."""
        return self.misses

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return 1.0 if total == 0 else self.hits / total

    @staticmethod
    def _build(key: ExecKey) -> Callable:
        from repro_torch import kernels as K

        def transform(batch, _key=key):
            return K.dwt_fwd_2d_multi(
                batch, levels=_key.levels, mode=_key.mode, scheme=_key.scheme
            )

        return transform

    def executable(self, key: ExecKey) -> Callable:
        """The cached callable for ``key`` (built on first use)."""
        fn = self._cache.get(key)
        if fn is None:
            self.misses += 1
            obs.counter("serve.executor_cache", outcome="miss").inc()
            fn = self._build(key)
            self._cache[key] = fn
        else:
            self.hits += 1
            obs.counter("serve.executor_cache", outcome="hit").inc()
        obs.gauge("serve.executor_hit_rate").set(self.hit_rate())
        return fn

    def transform(self, batch, key: ExecKey):
        """Run the batch through the key's callable.  The span measures
        HOST enqueue wall time: kernel launches return before the device
        finishes, and the span adds no synchronisation."""
        fn = self.executable(key)
        bucket = "x".join(str(s) for s in key.bucket)
        with obs.span("serve.transform", subsystem="serve", bucket=bucket):
            return fn(batch)

    def warmup(self, keys) -> int:
        """Pre-build callables for ``keys``; returns how many were new."""
        new = 0
        for key in keys:
            if key not in self._cache:
                self.misses += 1
                obs.counter("serve.executor_cache", outcome="miss").inc()
                self._cache[key] = self._build(key)
                new += 1
        return new
