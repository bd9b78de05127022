"""Deterministic fault-injection harness for chaos testing.

Copied from ``repro.resilience.inject`` so the port imports nothing of
the reference package.  The port wires ``serve.transform`` and the
``ckpt.save.*`` sites so far; the other site names are kept so the two
harnesses stay one taxonomy.

Two halves, both seeded and replayable:

**Pure byte corrupters** — :func:`flip_bit`, :func:`flip_byte`,
:func:`truncate`, :func:`corrupt` — deterministic functions of
``(data, seed)`` used to damage WZRC/WZRS containers and checkpoint
files exactly the same way on every run.

**Armed fault sites** — production code marks its fault points with
:func:`check("site.name") <check>` (a no-op dict lookup when nothing is
armed, so the hot path pays one truthiness test).  Tests arm a
:class:`Fault` at a site by name; the Nth hit of that site then raises
:class:`InjectedFault` or sleeps, deterministically.  Sites currently
wired:

    ``ckpt.save.before_write``   _save_impl, before any leaf is written
    ``ckpt.save.mid_write``      _save_impl, between leaf writes
    ``ckpt.save.before_commit``  _save_impl, manifest written, dir not
                                 yet renamed into place
    ``ckpt.save.before_latest``  _save_impl, step dir committed, LATEST
                                 pointer not yet updated
    ``sharded.collective``       sharded collective watchdog, inside the
                                 timed region (a delay simulates a stuck
                                 neighbor)
    ``serve.transform``          WaveletServeEngine, before the batched
                                 transform (transient failure -> retry)
    ``serve.encode``             WaveletServeEngine, before the response
                                 encode

The registry is process-global and thread-safe (the async checkpoint
thread hits ``ckpt.save.*`` sites); :func:`reset` disarms everything —
test fixtures call it around every chaos test.

This module is stdlib-only on purpose: it must be importable from
the kernel and serve layers without pulling in torch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

# the documented fault classes the chaos suite and the bench resilience
# section sweep; gate.py mirrors this tuple as a literal (stdlib-only)
FAULT_CLASSES = (
    "bit-flip",
    "truncation",
    "save-crash",
    "pallas-failure",
    "stuck-neighbor",
    "deadline-miss",
)


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise`` fault at its site."""


@dataclasses.dataclass
class Fault:
    """One armed fault: what happens, and on which hits of the site.

    ``action`` is ``"raise"`` (raise :class:`InjectedFault` or ``exc``)
    or ``"delay"`` (sleep ``delay_s``).  The fault fires on hit numbers
    ``at_call .. at_call + times - 1`` (1-based); ``times=None`` fires
    on every hit from ``at_call`` on.
    """

    action: str = "raise"
    at_call: int = 1
    times: Optional[int] = 1
    delay_s: float = 0.0
    exc: Optional[BaseException] = None
    message: str = ""

    def __post_init__(self):
        if self.action not in ("raise", "delay"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.at_call < 1:
            raise ValueError("at_call is 1-based and must be >= 1")


_lock = threading.Lock()
_armed: Dict[str, Fault] = {}
_hits: Dict[str, int] = {}


def arm(site: str, fault: Optional[Fault] = None, **kw) -> Fault:
    """Arm a fault at ``site`` (keyword args build a :class:`Fault`)."""
    f = fault if fault is not None else Fault(**kw)
    with _lock:
        _armed[site] = f
        _hits[site] = 0
    return f


def disarm(site: str) -> None:
    with _lock:
        _armed.pop(site, None)
        _hits.pop(site, None)


def reset() -> None:
    """Disarm every site and clear hit counters."""
    with _lock:
        _armed.clear()
        _hits.clear()


def hits(site: str) -> int:
    """How many times ``site`` has been hit since it was armed."""
    with _lock:
        return _hits.get(site, 0)


def check(site: str) -> None:
    """Fault point: no-op unless a fault is armed at ``site``."""
    if not _armed:  # fast path: nothing armed anywhere
        return
    with _lock:
        fault = _armed.get(site)
        if fault is None:
            return
        _hits[site] = n = _hits.get(site, 0) + 1
    if n < fault.at_call:
        return
    if fault.times is not None and n >= fault.at_call + fault.times:
        return
    if fault.action == "delay":
        time.sleep(fault.delay_s)
        return
    if fault.exc is not None:
        raise fault.exc
    raise InjectedFault(
        fault.message or f"injected fault at {site} (hit {n})"
    )


@contextlib.contextmanager
def armed(site: str, fault: Optional[Fault] = None, **kw) -> Iterator[Fault]:
    """Arm a fault for the scope of a ``with`` block, then disarm it."""
    f = arm(site, fault, **kw)
    try:
        yield f
    finally:
        disarm(site)


# ---------------------------------------------------------------------------
# Deterministic byte corrupters (pure functions of (data, seed)).
# ---------------------------------------------------------------------------


def flip_bit(data: bytes, bit_index: int) -> bytes:
    """Flip one bit (bit 0 = LSB of byte 0).  Out-of-range rejected."""
    byte, bit = divmod(bit_index, 8)
    if not 0 <= byte < len(data):
        raise IndexError(f"bit {bit_index} outside {len(data)}-byte buffer")
    out = bytearray(data)
    out[byte] ^= 1 << bit
    return bytes(out)


def flip_byte(data: bytes, index: int, xor: int = 0xFF) -> bytes:
    """XOR one byte (``xor`` must be non-zero so the byte really changes)."""
    if not 0 <= index < len(data):
        raise IndexError(f"byte {index} outside {len(data)}-byte buffer")
    if not 0 < xor <= 0xFF:
        raise ValueError("xor must be in 1..255")
    out = bytearray(data)
    out[index] ^= xor
    return bytes(out)


def truncate(data: bytes, keep: int) -> bytes:
    """Keep the first ``keep`` bytes (a mid-stream cut)."""
    if not 0 <= keep <= len(data):
        raise ValueError(f"keep={keep} outside 0..{len(data)}")
    return bytes(data[:keep])


def corrupt(
    data: bytes,
    seed: int,
    n_bits: int = 1,
    region: Optional[Tuple[int, int]] = None,
) -> bytes:
    """Flip ``n_bits`` seeded-random bits inside ``region`` (default: all).

    Deterministic: the same ``(data-length, seed, n_bits, region)``
    always damages the same bits, so a failing chaos case replays
    exactly from its seed.
    """
    start, end = region if region is not None else (0, len(data))
    if not 0 <= start < end <= len(data):
        raise ValueError(f"bad region {region} for {len(data)} bytes")
    rng = random.Random(seed)
    out = bytes(data)
    for _ in range(n_bits):
        out = flip_bit(out, rng.randrange(start * 8, end * 8))
    return out
