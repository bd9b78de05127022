"""Typed error taxonomy for the WZRC/WZRS codec layer.

Copied from ``repro.codec.errors`` so the port imports nothing of the
reference package; the classes and their bases are the same.

Every decode-side failure raises one of these — never a bare
``struct.error`` / ``IndexError`` from a garbage or truncated buffer.
All classes subclass :class:`ValueError` so seed-era callers (and the
v1-era tests) catching ``ValueError`` keep working unchanged; new code
should catch :class:`CodecError` (or a specific subclass) instead.
"""
from __future__ import annotations


class CodecError(ValueError):
    """Base class for every typed WZRC/WZRS codec failure."""


class CorruptHeaderError(CodecError):
    """The container header failed its CRC or is structurally invalid.

    Nothing downstream of a damaged header can be trusted (band offsets
    and geometry live there), so header corruption is never partial —
    the whole blob is rejected.
    """


class CorruptBandError(CodecError):
    """One or more band blobs failed their CRCs and could not be healed.

    ``band_status`` (when present) carries the per-band outcome tuple
    (``"ok"`` | ``"reconstructed"`` | ``"corrupt"``) so callers can see
    exactly which bands survived; ``decode_pyramid_partial`` returns the
    survivors instead of raising this.
    """

    def __init__(self, message: str, band_status=()):
        super().__init__(message)
        self.band_status = tuple(band_status)


class TruncatedStreamError(CodecError):
    """A WZRS stream (or container body) ended mid-structure."""


class UnsupportedVersionError(CodecError):
    """The blob/stream was written by a format version this build
    doesn't know; decoding would mis-parse, so it fails loudly."""
