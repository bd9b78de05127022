"""The least time the card could take for a round trip, from shapes alone.

The forward transform reads every input sample once and writes every
band sample once; the inverse reads every band sample once and writes
every output sample once.  A pyramid holds exactly as many samples as
its input, so a round trip needs 4 x samples x itemsize bytes (16 B a
sample for int32), whatever kernels, levels or launches do it, and
whatever they read again.  No integer work bounds it: the 5/3 lifting
costs a few adds and shifts a sample against 16 B of traffic.

The peak is the H100 SXM data sheet's HBM3 rate at its 700 W limit,
fixed here and never read from the card.
"""
from __future__ import annotations

from math import prod
from typing import Sequence

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet, 700 W


def roundtrip_bytes(batch: int, shape: Sequence[int], itemsize: int) -> int:
    """Bytes a forward + inverse round trip of ``batch`` items of
    ``shape`` must move at the least."""
    return 4 * batch * prod(shape) * itemsize


def bound_ms(nbytes: float) -> float:
    """Milliseconds ``nbytes`` take at the peak rate."""
    return nbytes / PEAK_BYTES_PER_S * 1e3
