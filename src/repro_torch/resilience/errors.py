"""Typed error and warning taxonomy for the resilience subsystem.

Copied from ``repro.resilience.errors`` so the port imports nothing of
the reference package.  One deliberate difference: the port's
:class:`ResilienceWarning` derives from ``UserWarning``, not
``RuntimeWarning``, so a degraded-but-correct notice from the port is
never escalated by a ``-W error::RuntimeWarning`` filter meant for the
reference's categories.  The port has no backend-degrade warning at
all: a kernel that fails to build or launch raises.

The chaos invariant (tests/test_resilience.py, DESIGN.md §12) is that
every injected fault class resolves to exactly one of three outcomes:

  1. **bit-exact recovery** — the damaged artifact reconstructs exactly
     (per-band CRC + XOR parity in the WZRC v2 container, resume from
     the previous intact checkpoint, retry-then-succeed in serve);
  2. **documented degradation** — a slower-but-correct path takes over
     and a *typed warning* names the cliff (:class:`ResilienceWarning`
     subclasses);
  3. **typed error** — the failure surfaces as one of the classes below
     (every one a :class:`ResilienceError`), never a bare IndexError /
     struct.error / silent wrong answer.

Nothing in this module imports torch — the taxonomy must be importable
from the stdlib-only layers (gate.py fixtures, the injection harness).
"""
from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for every typed failure the resilience layer raises."""


class DeadlineExceededError(ResilienceError):
    """A serve request missed its per-request deadline.

    Attached to the request (``TransformRequest.error``) rather than
    raised through the engine: one late request must not poison the
    batch it would have ridden in.
    """


class RetryExhaustedError(ResilienceError):
    """A bounded-retry policy ran out of attempts.

    ``__cause__`` carries the last underlying failure.
    """


class LoadShedError(ResilienceError):
    """Admission control rejected a request (queue over budget).

    Raised from ``WaveletServeEngine.submit`` so backpressure reaches
    the caller synchronously instead of growing an unbounded queue.
    """


class CollectiveTimeoutError(ResilienceError):
    """A watchdogged collective did not complete within its deadline.

    Surfaces a stuck mesh neighbor as an error the controller can act on
    (evict/reshard/restart) instead of hanging the host forever inside
    the runtime.
    """


class IntegerOverflowError(ResilienceError, OverflowError):
    """An integer transform would have wrapped (or its result cannot be
    represented in the requested band dtype).

    Raised by the checked execution mode (``checked=True`` /
    ``REPRO_DWT_CHECKED=1``) of every transform engine, and by the
    boundary validators (codec encode, checkpoint wavelet codecs,
    quantize, serve admission) when samples fall outside the derived
    range certificate (``repro.core.ranges``).  Subclasses the builtin
    ``OverflowError`` so numeric-minded callers catch it naturally;
    being a :class:`ResilienceError` keeps it inside the one typed
    taxonomy the chaos suite enforces.
    """


class CheckpointIntegrityError(ResilienceError, OSError):
    """A checkpoint leaf failed its integrity check and could not heal.

    Subclasses ``OSError`` (== ``IOError``) so seed-era callers catching
    ``IOError`` on restore keep working; the message always contains
    ``"checksum"`` for the same reason.
    """


class ResilienceWarning(UserWarning):
    """Base category for degraded-but-correct resilience outcomes.

    A dedicated category so operators can filter or escalate resilience
    notices independently of other warnings (see the module docstring
    for why it is not a ``RuntimeWarning`` here).
    """


class DegradedRestoreWarning(ResilienceWarning):
    """A checkpoint leaf failed its whole-file checksum but decoded via
    the container's per-band CRC + parity self-healing path."""


class RetryWarning(ResilienceWarning):
    """A transient failure was retried (and eventually succeeded)."""
