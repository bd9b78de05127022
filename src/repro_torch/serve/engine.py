"""Wavelet transform serving engine: 2-D images and 3-D volumes.

Port of ``repro.serve.engine``.  Requests of any shape a registered
bucket contains are admitted (``serve/scheduler.py``): the batch row is
zero-padded to the bucket, the transform stays static shaped, and the
response records the original shape so clients crop after the inverse
transform (:func:`crop_result`) — the padding lies outside the data, so
reconstruction stays bit-exact.

Each micro-batch is assembled on the host as int32, moved to the
engine's ``device`` and transformed by ``kernels.dwt_fwd_2d_multi``
(2-D buckets, ``(H, W)``) or ``kernels.dwt_fwd_nd(..., ndim=3)`` (volume
buckets, ``(D, H, W)``, or the legacy ``depth=``): on ``cuda`` (the
default) through the hand-written kernels, on ``cpu`` through their
plain versions.  ``device="cuda"`` on a machine without a
card raises at the first :meth:`WaveletServeEngine.warmup` or
:meth:`~WaveletServeEngine.step`; the engine never serves on the CPU
unless asked to.

Overload and failure semantics are the reference's: load shedding at
``max_queue``, per-request deadlines (re-checked on the retry-exhausted
re-queue path), and bounded retry with exponential backoff around the
transform.

``encode_response=True`` makes the engine a lossless codec service, as
in the reference: each micro-batch ships as ONE WZRC container whose
lead dim is the batch (``codec.encode_batch``), Rice-coded on the device
the bands live on (on the card, the Rice kernels; only the coded bytes
come to the host); a volume batch is a ``KIND_ND`` container with
``ndim=3``.  Every request carries the container and its
``batch_index``.  An injected or other failure of the batch encode
degrades to per-request containers; a failure of one request's encode
quarantines that request alone.  A kernel that fails to build or launch
(``KernelBuildError``, ``KernelLaunchError``, or torch's error for an
asynchronous CUDA fault) is neither: it propagates out of
:meth:`WaveletServeEngine.step`, and the batch goes back to its queue.

``checked=True`` (or ``REPRO_DWT_CHECKED``) certifies every request at
submit, as the reference: one host min/max and a cascade trace
(``core.ranges.assert_interval_safe``) reject a request whose samples
could wrap a lifting intermediate before it rides a batch.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) serves 2-D buckets
through the row-sharded transform (``kernels.dwt_fwd_2d_sharded`` over
``mesh[mesh_axis]``), as in the reference: every rank runs the same
engine on the same requests, each moves only its rows of the host batch
to its device, and the step gathers the bands (``full_tensor()``) before
it crops and encodes the responses, so responses and WZRC bytes are the
mesh-less engine's.  Each bucket must pass
``kernels.sharded.check_shardable``; volume buckets with a mesh raise the
reference's ``ValueError`` (the sharded route is 2-D only).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import ranges as _ranges
from repro_torch.kernels._build import is_kernel_fault
from repro_torch.resilience import inject
from repro_torch.resilience.errors import ResilienceWarning, RetryExhaustedError, RetryWarning
from repro_torch.serve.executor import ExecKey, TransformExecutor, mesh_signature
from repro_torch.serve.scheduler import BucketScheduler

Shape = Tuple[int, ...]


def _pyramid_rows(pyr, index):
    """The same pyramid (Pyramid2D or PyramidND) with every band indexed
    along its leading batch dim."""
    first, details = pyr
    return type(pyr)(first[index], tuple(tuple(b[index] for b in lvl) for lvl in details))


@dataclass
class TransformRequest:
    uid: int
    image: np.ndarray  # integer samples; any shape a registered bucket contains
    pyramid: Optional[Any] = None  # Pyramid2D / PyramidND of device tensors (when served)
    encoded: Optional[bytes] = None  # WZRC container (encoded-response route)
    batch_index: Optional[int] = None  # row in the batch container (None =
    # single-request container: decode with codec.decode_pyramid directly)
    bucket: Optional[Shape] = None  # the bucket this request rode (scheduler)
    done: bool = False
    submitted_at: Optional[float] = None  # monotonic clock, set by submit()
    error: Optional[Exception] = None  # per-request failure (deadline, encode)

    @property
    def padded(self) -> bool:
        """True when the request rode a bucket larger than its image."""
        return self.bucket is not None and tuple(self.image.shape) != self.bucket


@dataclass
class WaveletServeEngine:
    """Continuous micro-batched 2-D / 3-D DWT serving over shape buckets.

    ``buckets`` registers the served shape set — e.g.
    ``buckets=[(1024, 1024), (2048, 2048)]``, or volume buckets such as
    ``buckets=[(16, 256, 256), (64, 512, 512)]`` (one rank per engine) —
    each with its own FIFO queue and its own cached transform; a request
    routes to the smallest bucket containing its shape and is zero-padded
    up to it.  The legacy single-bucket constructor (``height=`` /
    ``width=``, and ``depth=`` for a volume bucket) still works.
    """

    height: Optional[int] = None
    width: Optional[int] = None
    depth: Optional[int] = None  # legacy single (D, H, W) volume bucket
    buckets: Optional[Sequence[Sequence[int]]] = None
    batch_slots: int = 8
    levels: int = 2
    mode: str = "paper"
    scheme: str = "cdf53"  # lifting scheme from the registry
    device: str = "cuda"
    encode_response: bool = False  # attach WZRC bytes to served requests
    mesh: Optional[Any] = None  # torch.distributed DeviceMesh -> sharded transform
    mesh_axis: str = "data"
    max_queue: int = 1024  # admission budget: submit() sheds beyond this
    deadline_s: Optional[float] = None  # per-request deadline (from submit)
    max_retries: int = 2  # transform retries after the first attempt
    retry_backoff_s: float = 0.05  # backoff base: 1x, 2x, 4x, ...
    checked: Optional[bool] = None  # range-certify at submit (None: env)
    executor: TransformExecutor = field(default_factory=TransformExecutor)

    def __post_init__(self):
        from repro_torch.core import lifting as _lifting
        from repro_torch.core import schemes as _schemes

        if self.batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {self.batch_slots}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        _schemes.get_scheme(self.scheme)  # fail fast on unknown names
        _schemes.check_mode(self.mode)

        if self.buckets is not None:
            if self.height is not None or self.width is not None or self.depth is not None:
                raise ValueError(
                    "pass either buckets= or the legacy height/width[/depth], not both"
                )
            bucket_list = [tuple(int(s) for s in b) for b in self.buckets]
        else:
            if self.height is None or self.width is None:
                raise ValueError("register buckets= or the legacy height=/width= pair")
            if self.depth is not None:
                bucket_list = [(self.depth, self.height, self.width)]
            else:
                bucket_list = [(self.height, self.width)]

        for b in bucket_list:
            if len(b) == 3:
                _lifting.check_levels_nd(b, self.levels)
                if self.mesh is not None:
                    raise ValueError(
                        "the sharded mesh route is 2D-only; volume buckets "
                        "(depth set) serve through the fused N-D engine"
                    )
            else:
                _lifting.check_levels_2d(b[0], b[1], self.levels)
            if self.mesh is not None:
                from repro_torch.kernels import sharded as _sharded
                from repro_torch.launch.mesh import axis_size

                _sharded.check_shardable(
                    b[0], b[1], axis_size(self.mesh, self.mesh_axis), self.levels, self.scheme,
                )

        self.scheduler = BucketScheduler(
            bucket_list, max_queue=self.max_queue, deadline_s=self.deadline_s
        )
        self._mesh_sig = mesh_signature(self.mesh)
        # requests that went overdue on the retry-exhausted re-queue
        # path; delivered (with their typed error) by the next step()
        self._expired_out: List[TransformRequest] = []

    # -- introspection ------------------------------------------------------

    @property
    def bucket_shape(self) -> Shape:
        """The single registered bucket (legacy engines)."""
        if len(self.scheduler.buckets) != 1:
            raise ValueError(
                f"engine serves {len(self.scheduler.buckets)} buckets "
                f"({list(self.scheduler.buckets)}); bucket_shape is single-bucket-only"
            )
        return self.scheduler.buckets[0]

    def _device(self) -> torch.device:
        from repro_torch.kernels import backend as _backend

        return _backend.resolve_device(self.device)

    def _exec_key(self, bucket: Shape) -> ExecKey:
        return ExecKey(
            bucket=bucket,
            batch_slots=self.batch_slots,
            scheme=self.scheme,
            levels=self.levels,
            mode=self.mode,
            device=str(self.device),
            mesh_axes=self._mesh_sig,
        )

    def warmup(self) -> int:
        """Build every bucket's transform and run it once on a zero batch,
        so kernel builds and first-launch costs land before traffic; with
        ``encode_response``, also build the Rice kernels and run an encode
        and a decode once.  Returns how many callables were new."""
        dev = self._device()
        new = self.executor.warmup((self._exec_key(b) for b in self.scheduler.buckets),
                                   self.mesh, self.mesh_axis)
        for b in self.scheduler.buckets:
            zeros = torch.zeros((self.batch_slots,) + b, dtype=torch.int32, device=dev)
            self.executor.executable(self._exec_key(b), self.mesh, self.mesh_axis)(zeros)
        if self.encode_response:
            from repro_torch.codec import rice

            probe = torch.arange(-300, 300, dtype=torch.int32, device=dev)
            back = rice.decode_band(*rice.encode_band(probe), probe.numel(), device=dev)
            if not torch.equal(back, probe):
                raise RuntimeError("Rice encode/decode warm-up did not round-trip")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return new

    # -- admission ----------------------------------------------------------

    def submit(self, req: TransformRequest) -> None:
        if not np.issubdtype(req.image.dtype, np.integer):
            raise TypeError(
                "integer DWT serving requires integer samples, got "
                f"{req.image.dtype}; quantize client-side before submitting"
            )
        bucket = self.scheduler.route(req.image.shape)  # ValueError if none
        if _ranges.checked_enabled(self.checked) and req.image.size:
            # admission-time range certification: reject a request whose
            # samples could wrap a lifting intermediate BEFORE it rides a
            # batch (one host min/max + a cascade trace, no device work)
            _ranges.assert_interval_safe(
                int(req.image.min()),
                int(req.image.max()),
                scheme=self.scheme,
                levels=self.levels,
                dtype=np.int32,  # step() batches every bucket as int32
                mode=self.mode,
                ndim=len(bucket),
                label=f"serve.submit(request {req.uid})",
            )
        self.scheduler.submit(req)  # sheds (LoadShedError) past max_queue

    # -- execution ----------------------------------------------------------

    def _transform(self, batch_np: np.ndarray, key: ExecKey, dev):
        """One attempt: the whole batch to ``dev``; or, on a mesh, the
        host batch to the sharded transform (each rank moves its rows)
        and the bands gathered whole."""
        batch = torch.from_numpy(batch_np)
        if self.mesh is None:
            return self.executor.transform(batch.to(dev), key)
        pyr = self.executor.transform(batch, key, self.mesh, self.mesh_axis)
        return type(pyr)(pyr.ll.full_tensor(),
                         tuple(tuple(b.full_tensor() for b in lvl) for lvl in pyr.details))

    def _transform_with_retry(self, batch_np: np.ndarray, key: ExecKey, dev):
        """Bounded-backoff retry around the batched transform; the device
        batch is rebuilt from the host batch on every attempt."""
        attempts = self.max_retries + 1
        for attempt in range(attempts):
            try:
                inject.check("serve.transform")
                out = self._transform(batch_np, key, dev)
            except Exception as e:  # noqa: BLE001 - transient device faults
                if attempt + 1 >= attempts:
                    obs.counter("serve.retries_exhausted").inc()
                    obs.emit(obs.FaultEvent(
                        subsystem="serve", error=type(e).__name__, site="serve.transform",
                    ))
                    raise RetryExhaustedError(
                        f"transform failed after {attempts} attempts: "
                        f"{type(e).__name__}: {e}"
                    ) from e
                obs.counter("serve.retry_attempts").inc()
                obs.warn_event(
                    obs.RetryEvent(
                        subsystem="serve", attempt=attempt + 1, attempts=attempts,
                        error=type(e).__name__,
                    ),
                    RetryWarning(
                        f"transform attempt {attempt + 1}/{attempts} failed "
                        f"({type(e).__name__}: {e}); retrying"
                    ),
                    stacklevel=3,
                )
                time.sleep(self.retry_backoff_s * (2 ** attempt))
            else:
                if attempt:
                    obs.emit(obs.HealEvent(
                        subsystem="serve", mechanism="retry",
                        detail=f"succeeded on attempt {attempt + 1}/{attempts}",
                    ))
                return out

    def _encode_batch(self, active: List[TransformRequest], pyr) -> None:
        """Batch-level response encode: ONE WZRC container per micro-batch
        (lead dim = the active batch).  Failure degrades to the
        per-request encode loop, where a failing request quarantines
        alone; kernel build and launch errors propagate."""
        from repro_torch.codec import container

        nd = 3 if len(active[0].bucket) == 3 else None
        n = len(active)
        try:
            inject.check("serve.encode_batch")
            blob = container.encode_batch(
                _pyramid_rows(pyr, slice(0, n)), scheme=self.scheme, mode=self.mode, ndim=nd
            )
        except Exception as e:  # noqa: BLE001 - degrade to per-request
            if is_kernel_fault(e):  # never "served without bytes"
                raise
            obs.counter("serve.encode_degrades").inc()
            obs.warn_event(
                obs.DegradeEvent(
                    subsystem="serve", requested="batch-encode",
                    resolved="per-request-encode", reason=f"{type(e).__name__}: {e}",
                ),
                ResilienceWarning(
                    f"batch-level response encode failed ({type(e).__name__}: {e}); "
                    "degrading to per-request encode"
                ),
                stacklevel=3,
            )
        else:
            for i, r in enumerate(active):
                r.encoded = blob
                r.batch_index = i
            return
        for r in active:
            try:
                inject.check("serve.encode")
                r.encoded = container.encode_pyramid(
                    r.pyramid, scheme=self.scheme, mode=self.mode, ndim=nd
                )
                r.batch_index = None
            except Exception as e:  # noqa: BLE001 - quarantine per request
                if is_kernel_fault(e):
                    raise
                r.error = e
                obs.counter("serve.encode_quarantines").inc()
                obs.warn_event(
                    obs.FaultEvent(
                        subsystem="serve", error=type(e).__name__, site="serve.encode",
                        detail=f"request {r.uid} quarantined",
                    ),
                    ResilienceWarning(
                        f"response encode failed for request {r.uid} "
                        f"({type(e).__name__}: {e}); serving the pyramid without "
                        "its encoded bytes"
                    ),
                    stacklevel=3,
                )

    def step(self) -> List[TransformRequest]:
        """Serve one micro-batch; returns the requests it completed.

        Deadline-missed requests come back alongside the served ones,
        with ``done=False`` and ``error`` set — check per request.  The
        pyramids are device tensors whose kernels may still be running:
        anything that reads them on the same stream is ordered after them.
        """
        dev = self._device()  # before any request leaves its queue
        overdue = self._expired_out + self.scheduler.expire_overdue()
        self._expired_out = []
        bucket, active = self.scheduler.next_batch(self.batch_slots)
        if bucket is None:
            return overdue
        bucket_label = "x".join(str(s) for s in bucket)
        t0 = time.perf_counter()
        # static batch shape: unfilled slots and the padding margin of
        # undersized requests are ZERO-filled
        batch = np.zeros((self.batch_slots,) + bucket, np.int32)
        for i, r in enumerate(active):
            batch[(i,) + tuple(slice(0, s) for s in r.image.shape)] = r.image
        key = self._exec_key(bucket)
        with obs.span("serve.step", subsystem="serve", bucket=bucket_label, n=len(active)):
            try:
                pyr = self._transform_with_retry(batch, key, dev)
            except RetryExhaustedError:
                # no live request is lost: the batch goes back to its queue
                # head; requests that went overdue during the failed
                # attempts are delivered (typed error) by the next step()
                expired, live = self.scheduler.expire_batch(active)
                self._expired_out.extend(expired)
                self.scheduler.requeue_front(bucket, live)
                raise
            for i, r in enumerate(active):
                r.pyramid = _pyramid_rows(pyr, i)
            if self.encode_response and active:
                try:
                    self._encode_batch(active, pyr)
                except Exception:
                    # a kernel fault: as on the retry-exhausted path, the
                    # batch goes back to its queue head, unserved
                    for r in active:
                        r.pyramid = r.encoded = r.batch_index = r.error = None
                    expired, live = self.scheduler.expire_batch(active)
                    self._expired_out.extend(expired)
                    self.scheduler.requeue_front(bucket, live)
                    raise
        for r in active:
            r.done = True
        obs.histogram("serve.batch_latency_ms", bucket=bucket_label).observe(
            (time.perf_counter() - t0) * 1e3
        )
        obs.counter("serve.requests_served").inc(len(active))
        obs.counter("serve.batches").inc()
        return overdue + active

    def run(self, requests: List[TransformRequest]) -> List[TransformRequest]:
        for r in requests:
            self.submit(r)
        done: List[TransformRequest] = []
        while self.scheduler.pending() or self._expired_out:
            done.extend(self.step())
        return done


def crop_result(arr, req: TransformRequest):
    """Crop a reconstructed bucket-shaped sample array back to the
    request's original shape (the zero-pad admission inverse).  A tensor
    stays a tensor on its device; anything else becomes a numpy array."""
    idx = tuple(slice(0, s) for s in req.image.shape)
    if isinstance(arr, torch.Tensor):
        return arr[idx]
    return np.asarray(arr)[idx]
