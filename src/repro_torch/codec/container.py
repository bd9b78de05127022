"""Self-describing bitstream container (WZRC) for integer wavelet pyramids.

Port of ``repro.codec.container``; the format is data, so the bytes are
the reference's byte for byte, both ways, for every pyramid kind (1-D
``WaveletPyramid``, 2-D ``Pyramid2D``, N-D ``PyramidND``), both versions,
with and without parity.  One blob = one pyramid: a header (magic,
version, kind, flags, mode, dtype, levels, ndim, lead dims, coder
geometry, scheme name, lead, shape, per-band blob lengths; in v2 also the
per-band CRCs, the parity group's length and CRC and a header CRC), then
one Rice blob per band in pack order (approx first, then per-level
detail bands coarsest->finest: ``[k u8 x nb][len u16 x nb][payload]``),
then the v1 CRC trailer or the v2 XOR parity blob.  See the reference
module's docstring for the full layout.

Where the port differs from the reference:

  * Bands are tensors and stay where they live: encode hands all of a
    pyramid's bands to ``rice.encode_bands`` as the tensors they are (on
    the card, one Rice kernel launch for all of them; only the coded
    bytes come back), and nothing here calls ``np.asarray`` on a band.  CRC32, parity and header assembly are host
    code on the coded bytes, as in the reference.
  * Decode rebuilds bands on ``device`` — the card by default, raising
    without one; ``device="cpu"`` runs the plain versions.
  * ``checked=True`` (or ``REPRO_DWT_CHECKED``) certifies the bands
    against the range certificate's band envelope
    (``core.ranges.assert_encodable``: one min/max per band where it
    lives, compared on the host in Python integers), as the reference.
  * :func:`inverse_transform` runs the port's inverses (1-D, 2-D and
    ``kernels.dwt_inv_nd`` for N-D) where the decoded bands live.
  * There is no ``backend=`` argument: the band's device is the choice.
"""
from __future__ import annotations

import struct
import time
import zlib
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.codec import rice
from repro_torch.codec.errors import (
    CodecError,
    CorruptBandError,
    CorruptHeaderError,
    TruncatedStreamError,
    UnsupportedVersionError,
)
from repro_torch.core import lifting, ranges
from repro_torch.core.schemes import get_scheme

MAGIC = b"WZRC"
FORMAT_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)

KIND_1D = 1
KIND_2D = 2
KIND_ND = 3

# per-band decode status values (DecodedPyramid.band_status)
BAND_OK = "ok"
BAND_RECONSTRUCTED = "reconstructed"
BAND_CORRUPT = "corrupt"

_MODES = {"paper": 0, "jpeg2000": 1}
_MODE_NAMES = {v: k for k, v in _MODES.items()}
_DTYPES = {np.dtype(np.int8): 1, np.dtype(np.int16): 2, np.dtype(np.int32): 3}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}
_TORCH_DTYPES = {
    torch.int8: np.dtype(np.int8), torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
}

_HEAD = struct.Struct("<4sBBBBBBBBHBB")

class DecodedPyramid(NamedTuple):
    """A decoded container: the pyramid plus its self-description.

    ``band_status`` is one entry per band in pack order — ``"ok"`` or
    ``"reconstructed"`` (parity-healed, still bit-exact).  v1 blobs
    (whole-blob CRC only) report all-``"ok"``.
    """

    pyramid: Any  # WaveletPyramid | Pyramid2D | PyramidND of tensors
    kind: int
    scheme: str
    mode: str
    levels: int
    lead: Tuple[int, ...]
    shape: Tuple[int, ...]  # original trailing (pre-transform) shape
    dtype: np.dtype
    band_status: Tuple[str, ...] = ()


class PartialDecode(NamedTuple):
    """A quarantining decode: every recoverable band, plus per-band fate.

    Corrupt bands are zero-filled in the pyramid (shape/dtype correct,
    content lost) so the structure stays a valid pyramid.
    """

    pyramid: Any
    kind: int
    scheme: str
    mode: str
    levels: int
    lead: Tuple[int, ...]
    shape: Tuple[int, ...]
    dtype: np.dtype
    band_status: Tuple[str, ...]

    @property
    def complete(self) -> bool:
        """True when every band decoded bit-exactly (incl. healed)."""
        return all(s != BAND_CORRUPT for s in self.band_status)


# ---------------------------------------------------------------------------
# Pyramid introspection: kind, band list in pack order, original shape.
# ---------------------------------------------------------------------------


def _pyramid_kind(pyr: Any) -> int:
    if isinstance(pyr, lifting.WaveletPyramid):
        return KIND_1D
    if isinstance(pyr, lifting.Pyramid2D):
        return KIND_2D
    if isinstance(pyr, lifting.PyramidND):
        return KIND_ND
    raise TypeError(f"expected WaveletPyramid / Pyramid2D / PyramidND, got {type(pyr)!r}")


def _flatten_bands(pyr: Any, kind: int) -> List[torch.Tensor]:
    """Bands in pack order (approx, then levels coarsest->finest), as the
    tensors they are: nothing moves to the host."""
    if kind == KIND_1D:
        return [pyr.approx] + list(pyr.details)
    if kind == KIND_2D:
        out = [pyr.ll]
        for lh, hl, hh in pyr.details:
            out.extend([lh, hl, hh])
        return out
    out = [pyr.approx]
    for lvl in pyr.details:
        out.extend(lvl)
    return out


def _leaves(pyr: Any) -> List[torch.Tensor]:
    return _flatten_bands(pyr, _pyramid_kind(pyr))


def _map_bands(fn, pyr: Any) -> Any:
    """The same pyramid with ``fn`` applied to every band."""
    if isinstance(pyr, lifting.WaveletPyramid):
        return type(pyr)(approx=fn(pyr.approx), details=tuple(fn(d) for d in pyr.details))
    if isinstance(pyr, lifting.Pyramid2D):
        return type(pyr)(ll=fn(pyr.ll), details=tuple(tuple(fn(b) for b in lvl) for lvl in pyr.details))
    return type(pyr)(approx=fn(pyr.approx), details=tuple(tuple(fn(b) for b in lvl) for lvl in pyr.details))


def _infer_geometry(
    pyr: Any, kind: int, ndim_hint: Optional[int]
) -> Tuple[int, Tuple[int, ...], Tuple[int, ...]]:
    """(ndim, lead_dims, original trailing shape) from the band shapes."""
    if kind == KIND_1D:
        n = pyr.approx.shape[-1] + sum(d.shape[-1] for d in pyr.details)
        return 1, tuple(pyr.approx.shape[:-1]), (n,)
    if kind == KIND_2D:
        h, w = pyr.ll.shape[-2], pyr.ll.shape[-1]
        for lh, hl, _hh in pyr.details:  # coarsest first
            h, w = h + lh.shape[-2], w + hl.shape[-1]
        return 2, tuple(pyr.ll.shape[:-2]), (h, w)
    if pyr.details:
        nd = pyr.ndim
        if ndim_hint is not None and ndim_hint != nd:
            raise ValueError(f"ndim={ndim_hint} but pyramid has ndim={nd}")
    elif ndim_hint is None:
        raise ValueError("levels=0 PyramidND: pass ndim explicitly")
    else:
        nd = ndim_hint
    dims = list(pyr.approx.shape[-nd:])
    for lvl in pyr.details:  # coarsest first; single-bit codes carry odds
        for j in range(nd):
            band = lvl[(1 << j) - 1]  # code (1 << j) at index code-1
            axis = nd - 1 - j
            dims[axis] += band.shape[-nd:][axis]
    return nd, tuple(pyr.approx.shape[:-nd]), tuple(dims)


def _expected_band_shapes(
    kind: int, shape: Tuple[int, ...], levels: int
) -> List[Tuple[int, ...]]:
    """Per-band trailing shapes in pack order — the decode geometry."""
    if kind == KIND_1D:
        a_len, d_lens = lifting.band_sizes(shape[0], levels)
        return [(a_len,)] + [(dl,) for dl in d_lens]
    if kind == KIND_2D:
        ll, det = lifting.band_shapes_2d(shape[0], shape[1], levels)
        out = [ll]
        for lvl in det:
            out.extend(lvl)
        return out
    approx, det = lifting.band_shapes_nd(tuple(shape), levels)
    out = [approx]
    for lvl in det:
        out.extend(lvl)
    return out


def _xor_parity(blobs: Sequence[bytes], plen: int) -> bytes:
    """XOR of the blobs zero-padded to ``plen`` — the parity group."""
    acc = np.zeros(plen, np.uint8)
    for b in blobs:
        arr = np.frombuffer(b, np.uint8)
        acc[: len(arr)] ^= arr
    return acc.tobytes()


def _band_dtype(band: torch.Tensor) -> np.dtype:
    """The container's dtype of a tensor band (int8, int16 or int32)."""
    if band.dtype not in _TORCH_DTYPES:
        raise TypeError(
            f"band dtype must be one of {sorted(str(d) for d in _DTYPES)}, got {band.dtype}"
        )
    return _TORCH_DTYPES[band.dtype]


# ---------------------------------------------------------------------------
# Encode.
# ---------------------------------------------------------------------------


def _raw_nbytes(pyr: Any) -> int:
    """Uncompressed band bytes, from shape/dtype metadata only."""
    return sum(int(b.numel()) * b.element_size() for b in _leaves(pyr))


def encode_pyramid(
    pyr: Any,
    scheme: str = "cdf53",
    mode: str = "paper",
    *,
    ndim: Optional[int] = None,
    checksum: bool = True,
    parity: bool = False,
    version: int = FORMAT_VERSION,
    checked: Optional[bool] = None,
) -> bytes:
    """Serialize an integer wavelet pyramid (see :func:`_encode_impl`),
    recording encode duration, coded bytes and the raw/coded ratio in the
    obs registry (``codec.encode_*``)."""
    t0 = time.perf_counter()
    with obs.span("codec.encode_pyramid", subsystem="codec"):
        out = _encode_impl(
            pyr, scheme, mode, ndim=ndim, checksum=checksum, parity=parity,
            version=version, checked=checked,
        )
    dur_ms = (time.perf_counter() - t0) * 1e3
    obs.counter("codec.encode_calls").inc()
    obs.counter("codec.encode_bytes").inc(len(out))
    obs.histogram("codec.encode_ms").observe(dur_ms)
    raw = _raw_nbytes(pyr)
    if raw and out:
        obs.gauge("codec.compression_ratio").set(raw / len(out))
    return out


def _encode_impl(
    pyr: Any,
    scheme: str = "cdf53",
    mode: str = "paper",
    *,
    ndim: Optional[int] = None,
    checksum: bool = True,
    parity: bool = False,
    version: int = FORMAT_VERSION,
    checked: Optional[bool] = None,
) -> bytes:
    """Serialize an integer wavelet pyramid to a self-describing blob.

    Every band is Rice-coded independently where it lives; ``version=2``
    (default) writes per-band CRCs plus a header CRC, ``parity=True``
    adds the XOR parity group; ``version=1`` emits the legacy layout
    (``checksum`` controls its whole-blob trailer) and supports no parity.
    """
    kind = _pyramid_kind(pyr)
    if version not in SUPPORTED_VERSIONS:
        raise UnsupportedVersionError(
            f"cannot encode WZRC version {version} (supports {SUPPORTED_VERSIONS})"
        )
    if parity and version < 2:
        raise ValueError("parity requires WZRC version 2")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    nd, lead, shape = _infer_geometry(pyr, kind, ndim)
    levels = len(pyr.details)
    bands = _flatten_bands(pyr, kind)

    dt = _band_dtype(bands[0])
    expected = _expected_band_shapes(kind, shape, levels)
    if len(bands) != len(expected):
        raise ValueError(
            f"malformed pyramid: {len(bands)} bands, geometry expects {len(expected)}"
        )
    for band, want in zip(bands, expected):
        if _band_dtype(band) != dt:
            raise TypeError(f"mixed band dtypes ({band.dtype} vs {dt}); cast first")
        if tuple(band.shape) != lead + want:
            raise ValueError(
                f"malformed pyramid: band shape {tuple(band.shape)}, "
                f"geometry expects {lead + want}"
            )

    if ranges.checked_enabled(checked) and levels > 0:
        try:
            get_scheme(scheme)
        except ValueError:
            pass  # foreign scheme name: container records it, can't derive
        else:
            ranges.assert_encodable(
                bands, scheme=scheme, levels=levels, ndim=nd, mode=mode,
                label="codec.encode_pyramid",
            )

    coded = rice.encode_bands(bands)
    return assemble(coded, kind, scheme, mode, dt, levels, nd, lead, shape,
                    checksum=checksum, parity=parity, version=version)


def assemble(
    coded: Sequence[Tuple[bytes, np.ndarray, np.ndarray]],
    kind: int, scheme: str, mode: str, dt: np.dtype, levels: int, nd: int,
    lead: Tuple[int, ...], shape: Tuple[int, ...], *,
    checksum: bool = True, parity: bool = False, version: int = FORMAT_VERSION,
) -> bytes:
    """The container's host part: header, band blobs from each band's
    ``(payload, k, lens)``, CRC32s and the parity group."""
    scheme_b = scheme.encode("utf-8")
    if len(scheme_b) > 255:
        raise ValueError("scheme name too long")
    flags = 1 if (checksum and version == 1) else 0
    parts = [
        _HEAD.pack(
            MAGIC, version, kind, flags, _MODES[mode], _DTYPES[dt], levels, nd, len(lead),
            rice.BLOCK_VALUES, rice.Q_MAX, rice.K_MAX,
        ),
        bytes([len(scheme_b)]),
        scheme_b,
        struct.pack(f"<{len(lead)}I", *lead) if lead else b"",
        struct.pack(f"<{nd}I", *shape),
    ]
    blobs = [ks.tobytes() + lens.astype("<u2").tobytes() + payload for payload, ks, lens in coded]
    parts.append(struct.pack(f"<{len(blobs)}I", *(len(b) for b in blobs)))
    if version == 1:
        parts.extend(blobs)
        out = b"".join(parts)
        if flags & 1:
            out += struct.pack("<I", zlib.crc32(out) & 0xFFFFFFFF)
        return out
    # v2: per-band CRCs, optional parity group, header CRC
    band_crcs = [zlib.crc32(b) & 0xFFFFFFFF for b in blobs]
    parts.append(struct.pack(f"<{len(band_crcs)}I", *band_crcs))
    parity_blob = b""
    parity_crc = 0
    if parity and blobs:
        parity_blob = _xor_parity(blobs, max(len(b) for b in blobs))
        parity_crc = zlib.crc32(parity_blob) & 0xFFFFFFFF
    parts.append(struct.pack("<II", len(parity_blob), parity_crc))
    header = b"".join(parts)
    header += struct.pack("<I", zlib.crc32(header) & 0xFFFFFFFF)
    return header + b"".join(blobs) + parity_blob


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------


class _Header(NamedTuple):
    version: int
    kind: int
    flags: int
    mode: str
    dtype: np.dtype
    levels: int
    ndim: int
    scheme: str
    lead: Tuple[int, ...]
    shape: Tuple[int, ...]
    blob_lens: Tuple[int, ...]
    body_off: int  # offset of the first band blob
    band_crcs: Tuple[int, ...] = ()  # v2 only
    parity_len: int = 0  # v2 only
    parity_crc: int = 0  # v2 only


def _parse_header(data: bytes) -> _Header:
    if len(data) < _HEAD.size or data[:4] != MAGIC:
        raise CorruptHeaderError("not a WZRC container (bad magic)")
    try:
        return _parse_header_body(data)
    except (struct.error, IndexError) as e:
        # the variable-length tail ran past the buffer: corrupt counts or
        # a truncated blob — surface the module's documented error type
        raise CorruptHeaderError(f"truncated or corrupt WZRC header ({e})") from e


def n_bands(kind: int, levels: int, nd: int) -> int:
    if kind == KIND_1D:
        return 1 + levels
    if kind == KIND_2D:
        return 1 + 3 * levels
    return 1 + ((1 << nd) - 1) * levels


def _parse_header_body(data: bytes) -> _Header:
    (_, version, kind, flags, mode_c, dtype_c, levels, nd, nlead, block, qmax, kmax) = (
        _HEAD.unpack_from(data, 0)
    )
    if version not in SUPPORTED_VERSIONS:
        raise UnsupportedVersionError(
            f"WZRC container version {version} not supported by this build "
            f"(supports {SUPPORTED_VERSIONS})"
        )
    if (block, qmax, kmax) != (rice.BLOCK_VALUES, rice.Q_MAX, rice.K_MAX):
        raise CorruptHeaderError(
            f"container coded with rice geometry (block={block}, "
            f"qmax={qmax}, kmax={kmax}); this build uses "
            f"({rice.BLOCK_VALUES}, {rice.Q_MAX}, {rice.K_MAX})"
        )
    if kind not in (KIND_1D, KIND_2D, KIND_ND):
        raise CorruptHeaderError(f"unknown pyramid kind {kind}")
    if mode_c not in _MODE_NAMES or dtype_c not in _DTYPE_NAMES:
        raise CorruptHeaderError("corrupt container header (mode/dtype code)")
    off = _HEAD.size
    slen = data[off]
    off += 1
    scheme = data[off : off + slen].decode("utf-8", errors="replace")
    off += slen
    lead = struct.unpack_from(f"<{nlead}I", data, off)
    off += 4 * nlead
    shape = struct.unpack_from(f"<{nd}I", data, off)
    off += 4 * nd
    nbands = n_bands(kind, levels, nd)
    blob_lens = struct.unpack_from(f"<{nbands}I", data, off)
    off += 4 * nbands
    band_crcs: Tuple[int, ...] = ()
    parity_len = 0
    parity_crc = 0
    if version >= 2:
        band_crcs = struct.unpack_from(f"<{nbands}I", data, off)
        off += 4 * nbands
        parity_len, parity_crc = struct.unpack_from("<II", data, off)
        off += 8
        (want_crc,) = struct.unpack_from("<I", data, off)
        got_crc = zlib.crc32(data[:off]) & 0xFFFFFFFF
        off += 4
        if got_crc != want_crc:
            raise CorruptHeaderError(
                f"WZRC header checksum mismatch (crc32 {got_crc:#010x} != {want_crc:#010x})"
            )
    return _Header(
        version=version, kind=kind, flags=flags, mode=_MODE_NAMES[mode_c],
        dtype=_DTYPE_NAMES[dtype_c], levels=levels, ndim=nd, scheme=scheme,
        lead=tuple(lead), shape=tuple(shape), blob_lens=tuple(blob_lens), body_off=off,
        band_crcs=band_crcs, parity_len=parity_len, parity_crc=parity_crc,
    )


def peek(data: bytes) -> dict:
    """Header metadata without decoding any band (cheap introspection)."""
    h = _parse_header(data)
    return {
        "version": h.version,
        "kind": h.kind,
        "scheme": h.scheme,
        "mode": h.mode,
        "levels": h.levels,
        "ndim": h.ndim,
        "lead": h.lead,
        "shape": h.shape,
        "dtype": str(h.dtype),
        "band_bytes": h.blob_lens,
        "parity_bytes": h.parity_len,
    }


def _band_coding(blob: bytes, count: int) -> "rice.Checked":
    """A band blob's tables and payload, checked on the host (no copy of
    the payload: a view of the blob).  Raises ``TruncatedStreamError`` or
    ``ValueError``."""
    nb = rice.n_blocks(count)
    need = nb + 2 * nb
    if len(blob) < need:
        raise TruncatedStreamError(f"band blob truncated: {len(blob)} bytes, tables need {need}")
    ks = np.frombuffer(blob, np.uint8, nb)
    lens = np.frombuffer(blob, "<u2", nb, offset=nb)
    return rice.check_band(memoryview(blob)[need:], ks, lens, count)


def _band_count(h: _Header, shp: Tuple[int, ...]) -> int:
    count = 1
    for s in h.lead + tuple(shp):
        count *= s
    return count


def _to_band(flat: torch.Tensor, h: _Header, shp: Tuple[int, ...]) -> torch.Tensor:
    """A decoded flat int32 band as the container's dtype and shape."""
    return flat.to(getattr(torch, h.dtype.name)).reshape(h.lead + tuple(shp))


def _band_blobs(data: bytes, h: _Header) -> Tuple[List[Optional[bytes]], List[str]]:
    """Slice out the band blobs in pack order, with their status: v1
    checks the whole-container CRC32 (raises on a mismatch), v2 each
    band's (:func:`_band_blobs_v2`)."""
    if h.version != 1:
        return _band_blobs_v2(data, h)
    end = len(data)
    if h.flags & 1:
        end -= 4
        (want,) = struct.unpack_from("<I", data, end)
        got = zlib.crc32(data[:end]) & 0xFFFFFFFF
        if got != want:
            raise CodecError(f"WZRC checksum mismatch (crc32 {got:#010x} != {want:#010x})")
    if h.body_off + sum(h.blob_lens) != end:
        raise TruncatedStreamError(
            f"container body is {end - h.body_off} bytes, band table "
            f"sums to {sum(h.blob_lens)} (truncated or corrupt)"
        )
    blobs: List[Optional[bytes]] = []
    off = h.body_off
    for blen in h.blob_lens:
        blobs.append(data[off : off + blen])
        off += blen
    return blobs, [BAND_OK] * len(blobs)


def _band_blobs_v2(data: bytes, h: _Header) -> Tuple[List[Optional[bytes]], List[str]]:
    """Slice out the band blobs, CRC-check each, heal via parity.

    Returns (blobs, status) in pack order; a blob is ``None`` exactly
    when its status is ``"corrupt"``.
    """
    end = len(data)
    if h.body_off + sum(h.blob_lens) + h.parity_len != end:
        raise TruncatedStreamError(
            f"container body is {end - h.body_off} bytes, band table sums "
            f"to {sum(h.blob_lens) + h.parity_len} (truncated or corrupt)"
        )
    blobs: List[Optional[bytes]] = []
    status: List[str] = []
    off = h.body_off
    for blen, crc in zip(h.blob_lens, h.band_crcs):
        blob = data[off : off + blen]
        off += blen
        if zlib.crc32(blob) & 0xFFFFFFFF == crc:
            blobs.append(blob)
            status.append(BAND_OK)
        else:
            blobs.append(None)
            status.append(BAND_CORRUPT)
    damaged = [i for i, s in enumerate(status) if s == BAND_CORRUPT]
    if damaged and h.parity_len:
        parity = data[off : off + h.parity_len]
        parity_ok = zlib.crc32(parity) & 0xFFFFFFFF == h.parity_crc
        if parity_ok and len(damaged) == 1:
            i = damaged[0]
            intact = [b for b in blobs if b is not None]
            rec = bytes(
                np.frombuffer(parity, np.uint8)
                ^ np.frombuffer(_xor_parity(intact, h.parity_len), np.uint8)
            )[: h.blob_lens[i]]
            if zlib.crc32(rec) & 0xFFFFFFFF == h.band_crcs[i]:
                blobs[i] = rec
                status[i] = BAND_RECONSTRUCTED
    return blobs, status


def _assemble(h: _Header, bands: List[torch.Tensor]) -> Any:
    if h.kind == KIND_1D:
        return lifting.WaveletPyramid(approx=bands[0], details=tuple(bands[1:]))
    if h.kind == KIND_2D:
        details = tuple(
            (bands[1 + 3 * i], bands[2 + 3 * i], bands[3 + 3 * i]) for i in range(h.levels)
        )
        return lifting.Pyramid2D(ll=bands[0], details=details)
    per = (1 << h.ndim) - 1
    details = tuple(tuple(bands[1 + per * i : 1 + per * (i + 1)]) for i in range(h.levels))
    return lifting.PyramidND(approx=bands[0], details=details)


def _decode_common(data: bytes, partial: bool, device):
    """Shared strict/partial decode core: header, bands, assembly."""
    dev = _device(device)
    data = bytes(data)
    h = _parse_header(data)
    blobs, status = _band_blobs(data, h)
    band_shapes = _expected_band_shapes(h.kind, h.shape, h.levels)
    counts = [_band_count(h, shp) for shp in band_shapes]
    coded = {}
    for i, (blob, count) in enumerate(zip(blobs, counts)):
        if blob is not None:
            try:
                coded[i] = _band_coding(blob, count)
            except (CodecError, ValueError):
                # CRC-valid but undecodable should be impossible; treat
                # it as corruption rather than leaking a raw error
                status[i] = BAND_CORRUPT
    # every band that passed its checks in one decode (one launch on the card)
    flats = dict(zip(coded, rice.decode_checked(list(coded.values()), dev)))
    bands = [_to_band(flats[i] if i in flats else
                      torch.zeros(count, dtype=torch.int32, device=dev),  # quarantined
                      h, shp)
             for i, (count, shp) in enumerate(zip(counts, band_shapes))]

    healed = sum(1 for s in status if s == BAND_RECONSTRUCTED)
    if healed:
        obs.counter("codec.bands_healed").inc(healed)
        obs.emit(obs.HealEvent(
            subsystem="codec", mechanism="parity",
            detail=f"{healed} band(s) reconstructed from the parity group",
        ))
    damaged = [i for i, s in enumerate(status) if s == BAND_CORRUPT]
    if damaged and not partial:
        obs.counter("codec.decode_corrupt").inc()
        obs.emit(obs.FaultEvent(
            subsystem="codec", error="CorruptBandError", site="codec.decode",
            detail=f"bands {damaged} unrecoverable",
        ))
        raise CorruptBandError(
            f"WZRC band(s) {damaged} corrupt and unrecoverable "
            f"({'parity absent' if not h.parity_len else 'parity could not heal'}); "
            "use decode_pyramid_partial for the surviving bands",
            band_status=status,
        )
    return h, _assemble(h, bands), tuple(status)


def _device(device) -> torch.device:
    from repro_torch.kernels import backend as _backend

    return _backend.resolve_device(device)


def _timed_decode(data: bytes, partial: bool, device):
    """Instrumented wrapper around :func:`_decode_common`: span +
    duration/byte metrics (``codec.decode_*``) per container decode."""
    t0 = time.perf_counter()
    name = "codec.decode_pyramid_partial" if partial else "codec.decode_pyramid"
    with obs.span(name, subsystem="codec"):
        out = _decode_common(data, partial=partial, device=device)
    obs.counter("codec.decode_calls").inc()
    obs.counter("codec.decode_bytes").inc(len(data))
    obs.histogram("codec.decode_ms").observe((time.perf_counter() - t0) * 1e3)
    return out


def decode_pyramid(data: bytes, device="cuda") -> DecodedPyramid:
    """Reconstruct the pyramid (and its self-description) from bytes, its
    bands as tensors on ``device`` (the card by default).

    v2 blobs self-heal: a single damaged band reconstructs from the
    parity group when present.  Damage that cannot heal raises
    :class:`CorruptBandError`; :func:`decode_pyramid_partial` returns the
    intact bands instead.
    """
    h, pyr, status = _timed_decode(data, partial=False, device=device)
    return DecodedPyramid(
        pyramid=pyr, kind=h.kind, scheme=h.scheme, mode=h.mode, levels=h.levels,
        lead=h.lead, shape=h.shape, dtype=h.dtype, band_status=status,
    )


def decode_pyramid_partial(data: bytes, device="cuda") -> PartialDecode:
    """Quarantining decode: every recoverable band, corrupt bands
    zero-filled with ``band_status[i] == "corrupt"``.  Header damage
    still raises :class:`CorruptHeaderError`."""
    h, pyr, status = _timed_decode(data, partial=True, device=device)
    return PartialDecode(
        pyramid=pyr, kind=h.kind, scheme=h.scheme, mode=h.mode, levels=h.levels,
        lead=h.lead, shape=h.shape, dtype=h.dtype, band_status=status,
    )


def inverse_transform(dec):
    """Run the recorded inverse transform on a decoded pyramid, where its
    bands live: the container is self-describing, so the right engine
    (1-D / 2-D / N-D) and the recorded scheme/mode need no out-of-band
    metadata.  Accepts a :class:`DecodedPyramid` or a (complete)
    :class:`PartialDecode`."""
    from repro_torch import kernels as K

    if dec.kind == KIND_1D:
        return K.dwt_inv(dec.pyramid, mode=dec.mode, scheme=dec.scheme)
    if dec.kind == KIND_2D:
        return K.dwt_inv_2d_multi(dec.pyramid, mode=dec.mode, scheme=dec.scheme)
    if dec.levels == 0:
        return dec.pyramid.approx  # identity pyramid carries no band order
    return K.dwt_inv_nd(dec.pyramid, mode=dec.mode, scheme=dec.scheme)


def encode_batch(
    pyr: Any, scheme: str = "cdf53", mode: str = "paper", *, ndim: Optional[int] = None, **kw
) -> bytes:
    """Serialize a BATCH of pyramids as one container (lead dim = batch):
    the serve tier's contract.  Every band must carry a leading batch dim."""
    kind = _pyramid_kind(pyr)
    nd, lead, _ = _infer_geometry(pyr, kind, ndim)
    if not lead:
        raise ValueError(
            "encode_batch needs a leading batch dim on every band; got a "
            f"lead-free pyramid (trailing ndim={nd}) — use encode_pyramid "
            "for single requests"
        )
    return encode_pyramid(pyr, scheme, mode, ndim=ndim, **kw)


def decode_batch(data: bytes, device="cuda") -> List[Any]:
    """Split a batch container back into per-item pyramids (decoded once,
    on ``device``, then sliced along the leading batch dim)."""
    dec = decode_pyramid(data, device=device)
    if not dec.lead:
        raise ValueError("not a batch container (no lead dims); use decode_pyramid")
    return [_map_bands(lambda b, i=i: b[i], dec.pyramid) for i in range(dec.lead[0])]


def roundtrip_exact(pyr: Any, **kw) -> bool:
    """True when encode->decode reproduces every band bit-exactly (decoded
    on the device the pyramid lives on)."""
    leaves = _leaves(pyr)
    dec = decode_pyramid(encode_pyramid(pyr, **kw), device=leaves[0].device)
    got = _leaves(dec.pyramid)
    return len(got) == len(leaves) and all(
        a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))
        for a, b in zip(got, leaves)
    )
