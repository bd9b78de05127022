"""Cache of transform callables for the wavelet serve tier.

Port of ``repro.serve.executor``.  Every ``(bucket, batch_slots, scheme,
levels, mode, device, mesh)`` combination the engine can emit maps to exactly
one callable, built on first use and reused for the life of the engine.
PyTorch runs eagerly, so a callable is the level chain of
``kernels.dwt_fwd_2d_multi`` (2-D buckets) or ``kernels.dwt_fwd_nd``
(``ndim=3``, volume buckets) bound to its key — there is no ``jax.jit``
to trace and no donated input buffer; what the cache still pins is that
each key is resolved once.  ``hits`` / ``misses`` / ``compiles`` keep
their reference meaning (``compiles`` == distinct callables built).
CUDA-graph capture per key comes in a later slice.

The sharded (mesh) route is cached the same way, as the reference caches
it: a plain callable around ``kernels.dwt_fwd_2d_sharded``, its key
carrying the mesh's :func:`mesh_signature`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

from repro_torch import obs

Shape = Tuple[int, ...]
MeshAxes = Optional[Tuple[Tuple[str, int], ...]]


class ExecKey(NamedTuple):
    """Everything that selects a distinct transform callable."""

    bucket: Shape  # (H, W) or (D, H, W)
    batch_slots: int
    scheme: str
    levels: int
    mode: str
    device: str  # "cuda" / "cuda:N" / "cpu"
    mesh_axes: MeshAxes = None  # None = one device; else mesh_signature(mesh)


def mesh_signature(mesh: Optional[Any]) -> MeshAxes:
    """A hashable identity for a mesh: its ``((axis, size), ...)`` layout
    (a ``DeviceMesh``, or any mesh whose ``shape`` maps names to sizes)."""
    if mesh is None:
        return None
    from repro_torch.launch.mesh import axis_sizes

    return tuple(axis_sizes(mesh).items())


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
    def _build(key: ExecKey, mesh: Optional[Any] = None, axis: str = "data") -> Callable:
        from repro_torch import kernels as K

        if key.mesh_axes is not None:
            # the collective watchdog stays on the host, around the call
            def sharded_fn(batch, _mesh=mesh, _key=key):
                return K.dwt_fwd_2d_sharded(batch, _mesh, levels=_key.levels, mode=_key.mode,
                                            axis=axis, scheme=_key.scheme, checked=False)

            return sharded_fn

        # checked=False: admission (engine.submit) already certified every
        # request, as the reference's jitted transform skips it
        if len(key.bucket) == 3:
            def transform(batch, _key=key):
                return K.dwt_fwd_nd(batch, levels=_key.levels, mode=_key.mode,
                                    scheme=_key.scheme, ndim=3, checked=False)
        else:
            def transform(batch, _key=key):
                return K.dwt_fwd_2d_multi(batch, levels=_key.levels, mode=_key.mode,
                                          scheme=_key.scheme, checked=False)

        return transform

    def executable(self, key: ExecKey, mesh: Optional[Any] = None, axis: str = "data") -> Callable:
        """The cached callable for ``key`` (built on first use)."""
        fn = self._cache.get(key)
        if fn is None:
            self.misses += 1
            obs.counter("serve.executor_cache", outcome="miss").inc()
            fn = self._build(key, mesh, axis)
            self._cache[key] = fn
        else:
            self.hits += 1
            obs.counter("serve.executor_cache", outcome="hit").inc()
        obs.gauge("serve.executor_hit_rate").set(self.hit_rate())
        return fn

    def transform(self, batch, key: ExecKey, mesh: Optional[Any] = None, axis: str = "data"):
        """Run the batch through the key's callable.  The span measures
        HOST enqueue wall time: kernel launches return before the device
        finishes, and the span adds no synchronisation."""
        fn = self.executable(key, mesh, axis)
        bucket = "x".join(str(s) for s in key.bucket)
        with obs.span("serve.transform", subsystem="serve", bucket=bucket):
            return fn(batch)

    def warmup(self, keys, mesh: Optional[Any] = None, axis: str = "data") -> int:
        """Pre-build callables for ``keys``; returns how many were new."""
        new = 0
        for key in keys:
            if key not in self._cache:
                self.misses += 1
                obs.counter("serve.executor_cache", outcome="miss").inc()
                self._cache[key] = self._build(key, mesh, axis)
                new += 1
        return new
