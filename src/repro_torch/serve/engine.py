"""Wavelet transform serving engine: the 2-D route of the port.

Port of ``repro.serve.engine`` for 2-D buckets.  Requests of any shape a
registered bucket contains are admitted (``serve/scheduler.py``): the
batch row is zero-padded to the bucket, the transform stays static
shaped, and the response records the original shape so clients crop
after the inverse transform (:func:`crop_result`) — the padding lies
outside the data, so reconstruction stays bit-exact.

Each micro-batch is assembled on the host as int32, moved to the
engine's ``device`` and transformed by ``kernels.dwt_fwd_2d_multi``: on
``cuda`` (the default) through the hand-written kernels, on ``cpu``
through their plain versions.  ``device="cuda"`` on a machine without a
card raises at the first :meth:`WaveletServeEngine.warmup` or
:meth:`~WaveletServeEngine.step`; the engine never serves on the CPU
unless asked to.

Overload and failure semantics are the reference's: load shedding at
``max_queue``, per-request deadlines (re-checked on the retry-exhausted
re-queue path), and bounded retry with exponential backoff around the
transform.

Not ported yet, and refused with ``NotImplementedError``:
``encode_response=True`` (ROADMAP.md Queue 1, item 2: the codec),
``checked=True`` (item 4: checked ranges), 3-D buckets (item 5: the 3-D
engine) and ``mesh=`` (item 7: the sharded transform).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.resilience import inject
from repro_torch.resilience.errors import RetryExhaustedError, RetryWarning
from repro_torch.serve.executor import ExecKey, TransformExecutor
from repro_torch.serve.scheduler import BucketScheduler

Shape = Tuple[int, ...]

_NOT_PORTED = {
    "encode_response": "ROADMAP.md Queue 1 item 2 (the codec)",
    "checked": "ROADMAP.md Queue 1 item 4 (checked ranges)",
    "3-D buckets": "ROADMAP.md Queue 1 item 5 (the 3-D engine)",
    "mesh": "ROADMAP.md Queue 1 item 7 (the sharded transform)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see {_NOT_PORTED[what]}"
    )


@dataclass
class TransformRequest:
    uid: int
    image: np.ndarray  # integer samples; any shape a registered bucket contains
    pyramid: Optional[Any] = None  # Pyramid2D of device tensors (when served)
    bucket: Optional[Shape] = None  # the bucket this request rode (scheduler)
    done: bool = False
    submitted_at: Optional[float] = None  # monotonic clock, set by submit()
    error: Optional[Exception] = None  # per-request failure (deadline)

    @property
    def padded(self) -> bool:
        """True when the request rode a bucket larger than its image."""
        return self.bucket is not None and tuple(self.image.shape) != self.bucket


@dataclass
class WaveletServeEngine:
    """Continuous micro-batched 2-D DWT serving over shape buckets.

    ``buckets`` registers the served shape set — e.g.
    ``buckets=[(1024, 1024), (2048, 2048)]`` — each with its own FIFO
    queue and its own cached transform; a request routes to the smallest
    bucket containing its shape and is zero-padded up to it.  The legacy
    single-bucket constructor (``height=`` / ``width=``) still works.
    """

    height: Optional[int] = None
    width: Optional[int] = None
    depth: Optional[int] = None  # 3-D buckets: not ported yet
    buckets: Optional[Sequence[Sequence[int]]] = None
    batch_slots: int = 8
    levels: int = 2
    mode: str = "paper"
    scheme: str = "cdf53"  # lifting scheme from the registry
    device: str = "cuda"
    encode_response: bool = False
    mesh: Optional[Any] = None
    max_queue: int = 1024  # admission budget: submit() sheds beyond this
    deadline_s: Optional[float] = None  # per-request deadline (from submit)
    max_retries: int = 2  # transform retries after the first attempt
    retry_backoff_s: float = 0.05  # backoff base: 1x, 2x, 4x, ...
    checked: Optional[bool] = None
    executor: TransformExecutor = field(default_factory=TransformExecutor)

    def __post_init__(self):
        from repro_torch.core import lifting as _lifting
        from repro_torch.core import schemes as _schemes

        if self.encode_response:
            raise _not_ported("encode_response")
        if self.checked:
            raise _not_ported("checked")
        if self.mesh is not None:
            raise _not_ported("mesh")
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
                raise _not_ported("3-D buckets")
            bucket_list = [(self.height, self.width)]

        for b in bucket_list:
            if len(b) == 3:
                raise _not_ported("3-D buckets")
            _lifting.check_levels_2d(b[0], b[1], self.levels)

        self.scheduler = BucketScheduler(
            bucket_list, max_queue=self.max_queue, deadline_s=self.deadline_s
        )
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
        )

    def warmup(self) -> int:
        """Build every bucket's transform and run it once on a zero batch,
        so kernel builds and first-launch costs land before traffic.
        Returns how many callables were new."""
        dev = self._device()
        new = self.executor.warmup(self._exec_key(b) for b in self.scheduler.buckets)
        for b in self.scheduler.buckets:
            zeros = torch.zeros((self.batch_slots,) + b, dtype=torch.int32, device=dev)
            self.executor.executable(self._exec_key(b))(zeros)
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
        self.scheduler.submit(req)  # ValueError if no bucket; sheds past max_queue

    # -- execution ----------------------------------------------------------

    def _transform_with_retry(self, batch_np: np.ndarray, key: ExecKey, dev):
        """Bounded-backoff retry around the batched transform; the device
        batch is rebuilt from the host batch on every attempt."""
        attempts = self.max_retries + 1
        for attempt in range(attempts):
            try:
                inject.check("serve.transform")
                out = self.executor.transform(torch.from_numpy(batch_np).to(dev), key)
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
                r.pyramid = type(pyr)(
                    ll=pyr.ll[i],
                    details=tuple(tuple(b[i] for b in lvl) for lvl in pyr.details),
                )
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
