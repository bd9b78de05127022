"""Shape-bucketed request scheduling for the wavelet serve tier.

Copied from ``repro.serve.scheduler``: it does host bookkeeping only, so
only its imports change (the port's own ``obs`` and ``resilience``).

The serve engine used to be one shape bucket per engine: a request whose
image was not exactly ``(H, W)`` was rejected at submit.  This module is
the admission half of the layered service core (DESIGN.md §14):

  * **Buckets** — the engine registers a set of ``(H, W)`` (or
    ``(D, H, W)``) shapes, each with its own FIFO queue.  Static shapes
    are what keep the executor's compiled-executable cache finite: one
    executable per bucket, reused forever.
  * **Routing** — a request routes to the *smallest* registered bucket
    that contains its shape (every axis ``>=`` the request's).  An
    undersized request is admitted by zero-padding at transform time
    (the integer DWT of a zero-padded image is still losslessly
    invertible; the response records the original shape so clients crop
    after reconstruction).  A request no bucket contains is rejected
    with ``ValueError`` at submit — synchronously, like the old
    single-bucket mismatch.
  * **FIFO + fairness** — strictly FIFO within a bucket; across buckets
    the next micro-batch is drawn from the bucket whose *head* request
    has waited longest, so a hot bucket cannot starve a cold one.
  * **Overload semantics** — unchanged from the single-bucket engine
    (DESIGN.md §12): admission sheds with
    :class:`~repro.resilience.errors.LoadShedError` once the TOTAL
    queued count (across buckets) reaches ``max_queue``, and per-request
    deadlines expire queued requests with
    :class:`~repro.resilience.errors.DeadlineExceededError` before they
    ride a batch.

The scheduler holds no device state and runs no device work — it is plain
host bookkeeping, unit-testable without a transform behind it.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.resilience.errors import DeadlineExceededError, LoadShedError

Shape = Tuple[int, ...]


def _note_admission(outcome: str, uid, bucket: Optional[Shape]) -> None:
    """Count + log one admission outcome (admitted / shed /
    deadline-expired), labelled by bucket for per-shape rates."""
    b = "x".join(str(s) for s in bucket) if bucket else ""
    obs.counter("serve.admission", outcome=outcome, bucket=b).inc()
    obs.emit(obs.AdmissionEvent(
        subsystem="serve", outcome=outcome, uid=uid, bucket=b,
    ))


def _as_bucket(shape: Sequence[int]) -> Shape:
    b = tuple(int(s) for s in shape)
    if len(b) not in (2, 3):
        raise ValueError(f"buckets are (H, W) or (D, H, W), got {b}")
    if any(s < 1 for s in b):
        raise ValueError(f"bucket dims must be >= 1, got {b}")
    return b


def _elems(shape: Shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


class BucketScheduler:
    """Multi-bucket FIFO queue with nearest-bucket routing.

    ``requests`` handed to :meth:`submit` must carry the
    ``TransformRequest`` contract this package uses: ``image`` (an
    ndarray), ``submitted_at``, ``error``, ``bucket`` attributes.  The
    scheduler stamps ``submitted_at`` and ``bucket``; it never touches
    the image payload.
    """

    def __init__(
        self,
        buckets: Sequence[Sequence[int]],
        max_queue: int = 1024,
        deadline_s: Optional[float] = None,
    ):
        if not buckets:
            raise ValueError("need at least one bucket")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        shapes = [_as_bucket(b) for b in buckets]
        if len({len(b) for b in shapes}) != 1:
            raise ValueError(
                f"buckets must share one rank (all 2D or all 3D), got {shapes}"
            )
        if len(set(shapes)) != len(shapes):
            raise ValueError(f"duplicate buckets in {shapes}")
        # routing prefers the smallest containing bucket; sorting by
        # element count makes the first fit the best fit
        self.buckets: Tuple[Shape, ...] = tuple(
            sorted(shapes, key=lambda b: (_elems(b),) + b)
        )
        self.max_queue = max_queue
        self.deadline_s = deadline_s
        self._queues: Dict[Shape, Deque] = {b: deque() for b in self.buckets}

    @property
    def ndim(self) -> int:
        return len(self.buckets[0])

    def pending(self) -> int:
        """Total queued requests across every bucket."""
        return sum(len(q) for q in self._queues.values())

    def route(self, shape: Sequence[int]) -> Shape:
        """Smallest registered bucket containing ``shape``.

        Exact matches route to themselves (the common case — clients
        that pre-size to a bucket never pay padding).  Raises
        ``ValueError`` when no bucket contains the shape.
        """
        shp = tuple(int(s) for s in shape)
        if len(shp) != self.ndim:
            raise ValueError(
                f"request rank {len(shp)} != bucket rank {self.ndim} "
                f"(registered buckets: {list(self.buckets)})"
            )
        for b in self.buckets:  # sorted smallest-first: first fit is best
            if all(r <= s for r, s in zip(shp, b)):
                return b
        raise ValueError(
            f"no registered bucket contains shape {shp} "
            f"(buckets: {list(self.buckets)})"
        )

    def submit(self, req) -> Shape:
        """Admit a request: route, shed, stamp, enqueue.  Returns the bucket."""
        bucket = self.route(req.image.shape)
        if self.pending() >= self.max_queue:
            _note_admission("shed", req.uid, bucket)
            raise LoadShedError(
                f"serve queue at its admission budget ({self.max_queue} "
                f"requests); request {req.uid} shed — back off and resubmit"
            )
        req.submitted_at = time.monotonic()
        req.bucket = bucket
        self._queues[bucket].append(req)
        _note_admission("admitted", req.uid, bucket)
        obs.gauge("serve.queue_depth").set(self.pending())
        return bucket

    def _expire(self, reqs, now: float):
        """Split an iterable of requests into (overdue, live)."""
        overdue, live = [], []
        for r in reqs:
            waited = now - (r.submitted_at or now)
            if waited > self.deadline_s:
                r.error = DeadlineExceededError(
                    f"request {r.uid} waited {waited:.3f}s, over its "
                    f"{self.deadline_s}s deadline"
                )
                overdue.append(r)
            else:
                live.append(r)
        return overdue, live

    def expire_overdue(self) -> List:
        """Pull deadline-missed requests out of every queue (typed error)."""
        if self.deadline_s is None:
            return []
        now = time.monotonic()
        all_overdue: List = []
        for bucket, q in self._queues.items():
            overdue, live = self._expire(q, now)
            if overdue:
                all_overdue.extend(overdue)
                self._queues[bucket] = deque(live)
                for r in overdue:
                    _note_admission("deadline-expired", r.uid, bucket)
        if all_overdue:
            obs.gauge("serve.queue_depth").set(self.pending())
        return all_overdue

    def expire_batch(self, reqs) -> Tuple[List, List]:
        """Deadline-filter an already-drawn batch -> (overdue, live).

        Used on the retry-exhausted re-queue path: a batch that burned
        through its retry budget (with backoff sleeps) must not serve
        requests whose deadline passed while it was failing.
        """
        if self.deadline_s is None:
            return [], list(reqs)
        overdue, live = self._expire(reqs, time.monotonic())
        for r in overdue:
            _note_admission("deadline-expired", r.uid, r.bucket)
        return overdue, live

    def next_batch(self, batch_slots: int) -> Tuple[Optional[Shape], List]:
        """Draw the next micro-batch: up to ``batch_slots`` requests, FIFO,
        from the bucket whose head request has waited longest.

        Returns ``(None, [])`` when nothing is queued.
        """
        head_bucket: Optional[Shape] = None
        head_age: Optional[float] = None
        for bucket in self.buckets:
            q = self._queues[bucket]
            if not q:
                continue
            age = q[0].submitted_at or 0.0
            if head_age is None or age < head_age:
                head_bucket, head_age = bucket, age
        if head_bucket is None:
            return None, []
        q = self._queues[head_bucket]
        batch = [q.popleft() for _ in range(min(batch_slots, len(q)))]
        obs.gauge("serve.queue_depth").set(self.pending())
        return head_bucket, batch

    def requeue_front(self, bucket: Shape, reqs: Sequence) -> None:
        """Put a failed batch back at its queue head (oldest first)."""
        q = self._queues[bucket]
        for r in reversed(list(reqs)):
            q.appendleft(r)
