"""Fault injection and the typed error taxonomy, copied for the port.

    inject.py  deterministic fault-injection harness: named, armable
               fault sites (the port wires ``serve.transform``) and
               seeded byte/bit corrupters
    errors.py  the typed error/warning taxonomy every layer raises from

Copies of ``repro.resilience.inject`` / ``errors`` (stdlib-only), kept
separate so the port imports nothing of the reference package.
"""
from repro_torch.resilience.errors import (  # noqa: F401
    CheckpointIntegrityError,
    CollectiveTimeoutError,
    DeadlineExceededError,
    DegradedRestoreWarning,
    LoadShedError,
    ResilienceError,
    ResilienceWarning,
    RetryExhaustedError,
    RetryWarning,
)
from repro_torch.resilience.inject import (  # noqa: F401
    FAULT_CLASSES,
    Fault,
    InjectedFault,
    arm,
    armed,
    check,
    corrupt,
    disarm,
    flip_bit,
    flip_byte,
    reset,
    truncate,
)

__all__ = [
    "CheckpointIntegrityError",
    "CollectiveTimeoutError",
    "DeadlineExceededError",
    "DegradedRestoreWarning",
    "LoadShedError",
    "ResilienceError",
    "ResilienceWarning",
    "RetryExhaustedError",
    "RetryWarning",
    "FAULT_CLASSES",
    "Fault",
    "InjectedFault",
    "arm",
    "armed",
    "check",
    "corrupt",
    "disarm",
    "flip_bit",
    "flip_byte",
    "reset",
    "truncate",
]
