"""Progressive, byte-range decode of WZRC containers.

Port of ``repro.codec.progressive``.  The container header records every
band blob's byte length, so one stored bitstream serves many fidelity
tiers, each reading only the byte ranges it needs — exactly the ranges
the reference reads:

    decode_lowband(src)             the approximation band alone (the
                                    thumbnail tier): header + ONE blob
    decode_band(src, index)         any single band in pack order
    decode_progressive(src, L)      approx + the coarsest L detail levels,
                                    a valid pyramid with ``levels == L``

``src`` is ``bytes`` or any object with ``pread(offset, size)``, such as
:class:`CountingReader`.  Every tier re-verifies the header CRC and the
CRCs of exactly the bands it reads (v2); a failing band heals from the
XOR parity group (``heal=True``, the one path that reads the whole
body), quarantines zero-filled (``partial=True``) or raises
:class:`~repro_torch.codec.errors.CorruptBandError`.

Bands decode to tensors on ``device`` — the card by default (it raises
without one); ``device="cpu"`` runs the plain Rice decoder.
"""
from __future__ import annotations

import zlib
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.codec import container as C
from repro_torch.codec import rice
from repro_torch.codec.errors import CodecError, CorruptBandError, CorruptHeaderError

__all__ = [
    "BandDecode",
    "CountingReader",
    "band_byte_ranges",
    "decode_band",
    "decode_lowband",
    "decode_progressive",
    "read_header",
    "reconstruct",
]


# ---------------------------------------------------------------------------
# Byte-range sources.
# ---------------------------------------------------------------------------


class _BytesReader:
    """``pread`` view over an in-memory blob."""

    def __init__(self, data: bytes):
        self._data = bytes(data)

    def pread(self, offset: int, size: int) -> bytes:
        return self._data[offset : offset + size]


class CountingReader:
    """A ``pread`` source that accounts every byte it hands out, so a
    test can show that a tier reads only part of the blob."""

    def __init__(self, data: bytes):
        self._data = bytes(data)
        self.bytes_read = 0
        self.reads = 0

    def __len__(self) -> int:
        return len(self._data)

    def pread(self, offset: int, size: int) -> bytes:
        chunk = self._data[offset : offset + size]
        self.reads += 1
        self.bytes_read += len(chunk)
        return chunk


def _reader(src: Any):
    if hasattr(src, "pread"):
        return src
    if isinstance(src, (bytes, bytearray, memoryview)):
        return _BytesReader(bytes(src))
    raise TypeError(f"need bytes or an object with pread(offset, size), got {type(src)!r}")


# ---------------------------------------------------------------------------
# Header: staged ranged reads, then the container module's own parser.
# ---------------------------------------------------------------------------


def read_header(src: Any) -> C._Header:
    """Parse a container header from ranged reads alone: the fixed head
    (+ the scheme-length byte), then the exact variable tail it implies,
    then ``container._parse_header`` (v2 header CRC verified)."""
    r = _reader(src)
    fixed = r.pread(0, C._HEAD.size + 1)
    if len(fixed) < C._HEAD.size + 1 or fixed[:4] != C.MAGIC:
        raise CorruptHeaderError("not a WZRC container (bad magic)")
    (_, version, kind, _flags, _mode, _dt, levels, nd, nlead, _b, _q, _k) = (
        C._HEAD.unpack_from(fixed, 0)
    )
    slen = fixed[C._HEAD.size]
    nbands = C.n_bands(kind, levels, nd)
    tail = slen + 4 * nlead + 4 * nd + 4 * nbands
    if version >= 2:
        tail += 4 * nbands + 8 + 4  # band CRCs, parity (len, crc), header CRC
    prefix = fixed + r.pread(len(fixed), tail)
    return C._parse_header(prefix)


def band_byte_ranges(h: C._Header) -> List[Tuple[int, int]]:
    """Per-band ``(offset, length)`` into the container, pack order."""
    out = []
    off = h.body_off
    for blen in h.blob_lens:
        out.append((off, blen))
        off += blen
    return out


def _band_count(h: C._Header, up_to_level: int) -> int:
    per = {C.KIND_1D: 1, C.KIND_2D: 3}.get(h.kind, (1 << h.ndim) - 1)
    return 1 + per * up_to_level


# ---------------------------------------------------------------------------
# Band reads: CRC per band, parity healing, quarantine.
# ---------------------------------------------------------------------------


def _heal_from_parity(r, h: C._Header, index: int) -> Optional[bytes]:
    """Reconstruct band ``index`` from the XOR parity group (reads the
    whole body); ``None`` when parity is absent, damaged, or more than
    this band is broken."""
    if not h.parity_len:
        return None
    ranges = band_byte_ranges(h)
    parity_off = h.body_off + sum(h.blob_lens)
    parity = r.pread(parity_off, h.parity_len)
    if zlib.crc32(parity) & 0xFFFFFFFF != h.parity_crc:
        return None
    acc = np.frombuffer(parity, np.uint8).copy()
    for i, (off, blen) in enumerate(ranges):
        if i == index:
            continue
        blob = r.pread(off, blen)
        if zlib.crc32(blob) & 0xFFFFFFFF != h.band_crcs[i]:
            return None  # two damaged bands: XOR cannot isolate either
        arr = np.frombuffer(blob, np.uint8)
        acc[: len(arr)] ^= arr
    rec = acc.tobytes()[: h.blob_lens[index]]
    if zlib.crc32(rec) & 0xFFFFFFFF != h.band_crcs[index]:
        return None
    return rec


def _read_band_blob(r, h: C._Header, index: int, heal: bool) -> Tuple[Optional[bytes], str]:
    """One band's verified bytes -> (blob | None, band status)."""
    off, blen = band_byte_ranges(h)[index]
    blob = r.pread(off, blen)
    if len(blob) != blen:
        blob = None  # truncated source
    if h.version >= 2 and blob is not None:
        if zlib.crc32(blob) & 0xFFFFFFFF != h.band_crcs[index]:
            blob = None
    if blob is not None:
        return blob, C.BAND_OK
    if heal and h.version >= 2:
        rec = _heal_from_parity(r, h, index)
        if rec is not None:
            return rec, C.BAND_RECONSTRUCTED
    return None, C.BAND_CORRUPT


def _read_coded(r, h: C._Header, index: int, heal: bool, partial: bool):
    """One band's checked coding (None when quarantined) and status;
    without ``partial`` a band that cannot be decoded raises."""
    shp = C._expected_band_shapes(h.kind, h.shape, h.levels)[index]
    count = C._band_count(h, shp)
    blob, status = _read_band_blob(r, h, index, heal)
    coded = None
    if blob is not None:
        try:
            coded = C._band_coding(blob, count)
        except (CodecError, ValueError):
            status = C.BAND_CORRUPT
    if coded is None and not partial:
        raise CorruptBandError(
            f"WZRC band {index} corrupt and unrecoverable "
            f"({'parity absent' if not h.parity_len else 'parity could not heal'})",
            band_status=(status,),
        )
    return coded, status


def _decode_some(r, h: C._Header, indices, heal: bool, partial: bool, dev):
    """The bands ``indices`` from their byte ranges: each read and checked,
    then every one that passed decoded at once (one launch on the card),
    a quarantined one as zeros.  Returns (bands, statuses)."""
    read = [_read_coded(r, h, i, heal, partial) for i in indices]
    coded = [c for c, _ in read if c is not None]
    flats = iter(rice.decode_checked(coded, dev))
    shapes = C._expected_band_shapes(h.kind, h.shape, h.levels)
    bands = []
    for i, (c, _) in zip(indices, read):
        flat = next(flats) if c is not None else torch.zeros(
            C._band_count(h, shapes[i]), dtype=torch.int32, device=dev)
        bands.append(C._to_band(flat, h, shapes[i]))
    return bands, [st for _, st in read]


class BandDecode(NamedTuple):
    """One band plus the container self-description it decoded under."""

    band: Any  # (lead..., band shape) tensor
    index: int  # pack-order band index
    status: str  # "ok" | "reconstructed"
    kind: int
    scheme: str
    mode: str
    levels: int  # the CONTAINER's level count, not a tier
    lead: Tuple[int, ...]
    shape: Tuple[int, ...]
    dtype: np.dtype


def decode_band(src: Any, index: int, *, heal: bool = True, device="cuda") -> BandDecode:
    """Decode a single band (pack order; 0 is the approximation) from its
    byte range alone, CRC-verified (v2)."""
    dev = C._device(device)
    r = _reader(src)
    h = read_header(r)
    if not 0 <= index < len(h.blob_lens):
        raise ValueError(f"band index {index} out of range ({len(h.blob_lens)} bands)")
    (band,), (status,) = _decode_some(r, h, [index], heal, partial=False, dev=dev)
    return BandDecode(
        band=band, index=index, status=status, kind=h.kind, scheme=h.scheme, mode=h.mode,
        levels=h.levels, lead=h.lead, shape=h.shape, dtype=h.dtype,
    )


def decode_lowband(src: Any, *, heal: bool = True, device="cuda") -> BandDecode:
    """The approximation band alone — the thumbnail tier: the header plus
    one band blob; the band IS the low-resolution image."""
    return decode_band(src, 0, heal=heal, device=device)


def decode_progressive(
    src: Any, up_to_level: int, *, heal: bool = True, partial: bool = False, device="cuda",
) -> C.DecodedPyramid:
    """Decode the coarsest ``up_to_level`` detail levels (plus approx): a
    valid pyramid with ``levels == up_to_level``, bit for bit the full
    decode's truncated to its coarsest levels, reading only the byte
    ranges of the bands it returns."""
    dev = C._device(device)
    r = _reader(src)
    h = read_header(r)
    if not 0 <= up_to_level <= h.levels:
        raise ValueError(f"up_to_level must be in [0, {h.levels}], got {up_to_level}")
    bands, status = _decode_some(r, h, range(_band_count(h, up_to_level)), heal, partial, dev)
    trunc = h._replace(levels=up_to_level)
    return C.DecodedPyramid(
        pyramid=C._assemble(trunc, bands), kind=h.kind, scheme=h.scheme, mode=h.mode,
        levels=up_to_level, lead=h.lead, shape=h.shape, dtype=h.dtype,
        band_status=tuple(status),
    )


def reconstruct(dec: C.DecodedPyramid):
    """Inverse-transform a (possibly truncated) decode to samples, where
    its bands live; levels-0 decodes return the approx band unchanged."""
    if dec.levels == 0:
        return dec.pyramid.approx if hasattr(dec.pyramid, "approx") else dec.pyramid.ll
    return C.inverse_transform(dec)
