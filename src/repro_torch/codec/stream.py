"""Chunked / streaming encode-decode over the wavelet codec (WZRS).

Port of ``repro.codec.stream``.  A stream frames a sequence of WZRC
containers, each a complete self-describing blob, so a stream survives
being cut at any frame boundary::

    magic    4s  b"WZRS"
    version  u8  STREAM_VERSION
    flags    u8  reserved (0)
    reserved u16
    frames:  [u32 frame_len][container bytes]  repeated
    trailer: u32 0  (zero-length terminator)

:class:`StreamEncoder` forward-transforms each integer chunk over its
trailing ``ndim`` axes where ``device`` says (levels clamped per frame),
then container-encodes it; :func:`decode_stream` inverts each frame back
to a sample tensor on ``device``.  Frames are 1-D (``kernels.dwt_fwd``),
2-D (``kernels.dwt_fwd_2d_multi``) or N-D (``kernels.dwt_fwd_nd``: 3-D
volume slabs on the volume kernels).
"""
from __future__ import annotations

import io
import struct
from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.codec import container
from repro_torch.codec.errors import (
    CodecError,
    CorruptHeaderError,
    TruncatedStreamError,
    UnsupportedVersionError,
)
from repro_torch.core import lifting

STREAM_MAGIC = b"WZRS"
STREAM_VERSION = 1

_STREAM_HEAD = struct.Struct("<4sBBH")
_FRAME_LEN = struct.Struct("<I")

ByteSource = Union[bytes, bytearray, memoryview, io.IOBase, Iterable[bytes]]

def stream_header() -> bytes:
    return _STREAM_HEAD.pack(STREAM_MAGIC, STREAM_VERSION, 0, 0)


def frame(blob: bytes) -> bytes:
    """Length-prefix one container blob as a stream frame."""
    return _FRAME_LEN.pack(len(blob)) + blob


def terminator() -> bytes:
    return _FRAME_LEN.pack(0)


class StreamEncoder:
    """Transforms + encodes integer sample chunks into stream frames.

    Each chunk is forward-transformed over its trailing ``ndim`` axes
    (leading axes batch) on ``device`` with ``levels`` clamped to what
    the chunk's trailing shape supports, then container-encoded.
    """

    def __init__(
        self, levels: int = 2, scheme: str = "cdf53", mode: str = "paper", ndim: int = 2,
        device="cuda",
    ):
        from repro_torch.core import schemes

        schemes.get_scheme(scheme)  # fail fast on unknown names
        if levels < 0:
            raise ValueError("levels must be >= 0")
        if ndim < 1:
            raise ValueError("ndim must be >= 1")
        self.levels = levels
        self.scheme = scheme
        self.mode = mode
        self.ndim = ndim
        self.device = device

    def encode_frame(self, chunk) -> bytes:
        """One chunk -> one length-prefixed frame."""
        from repro_torch import kernels as K
        from repro_torch.kernels import backend as _backend

        x = chunk if isinstance(chunk, torch.Tensor) else torch.from_numpy(np.array(chunk))
        if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
            raise TypeError(
                f"stream codec takes integer samples, got {x.dtype}; quantize first"
            )
        if x.ndim < self.ndim:
            raise ValueError(f"chunk needs >= {self.ndim} axes, got shape {tuple(x.shape)}")
        x = x.to(_backend.resolve_device(self.device))
        trailing = tuple(x.shape[-self.ndim:])
        levels = min(self.levels, lifting.max_levels_nd(trailing))
        kw = dict(levels=levels, mode=self.mode, scheme=self.scheme)
        if self.ndim == 1:
            pyr = K.dwt_fwd(x, **kw)
        elif self.ndim == 2:
            pyr = K.dwt_fwd_2d_multi(x, **kw)
        else:
            pyr = K.dwt_fwd_nd(x, ndim=self.ndim, **kw)
        return frame(container.encode_pyramid(
            pyr, scheme=self.scheme, mode=self.mode, ndim=self.ndim if self.ndim >= 3 else None,
        ))

    def encode(self, chunks: Iterable) -> Iterator[bytes]:
        yield stream_header()
        for chunk in chunks:
            yield self.encode_frame(chunk)
        yield terminator()


# ---------------------------------------------------------------------------
# Reading side.
# ---------------------------------------------------------------------------


class _Reader:
    """Incremental reader over bytes / a file-like / an iterable of bytes."""

    def __init__(self, src: ByteSource):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self._file: Optional[io.IOBase] = io.BytesIO(bytes(src))
            self._iter: Optional[Iterator[bytes]] = None
        elif hasattr(src, "read"):
            self._file = src  # type: ignore[assignment]
            self._iter = None
        else:
            self._file = None
            self._iter = iter(src)  # type: ignore[arg-type]
        self._buf = bytearray()

    def read(self, n: int) -> bytes:
        if self._file is not None:
            # loop: unbuffered file-likes may return fewer than n bytes
            while len(self._buf) < n:
                chunk = self._file.read(n - len(self._buf))
                if not chunk:
                    break
                self._buf.extend(chunk)
        else:
            while len(self._buf) < n and self._iter is not None:
                try:
                    self._buf.extend(next(self._iter))
                except StopIteration:
                    self._iter = None
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def read_exact(self, n: int, what: str) -> bytes:
        data = self.read(n)
        if len(data) != n:
            raise TruncatedStreamError(
                f"WZRS stream truncated reading {what} ({len(data)}/{n} bytes)"
            )
        return data


def iter_frames(src: ByteSource) -> Iterator[bytes]:
    """Yield raw container blobs from a stream (header/trailer checked)."""
    r = _Reader(src)
    magic, version, _flags, _rsvd = _STREAM_HEAD.unpack(
        r.read_exact(_STREAM_HEAD.size, "stream header")
    )
    if magic != STREAM_MAGIC:
        raise CorruptHeaderError("not a WZRS stream (bad magic)")
    if version != STREAM_VERSION:
        raise UnsupportedVersionError(
            f"WZRS stream version {version} not supported by this build "
            f"(supports {STREAM_VERSION})"
        )
    while True:
        (flen,) = _FRAME_LEN.unpack(r.read_exact(_FRAME_LEN.size, "frame length"))
        if flen == 0:
            return
        yield r.read_exact(flen, "frame body")


def decode_stream(src: ByteSource, device="cuda") -> Iterator[torch.Tensor]:
    """Decode a stream back to sample chunks on ``device`` (bit-exact)."""
    for blob in iter_frames(src):
        dec = container.decode_pyramid(blob, device=device)
        yield container.inverse_transform(dec)


# ---------------------------------------------------------------------------
# Volume convenience: slab along the leading axis.
# ---------------------------------------------------------------------------


def encode_volume(
    x, slab: int = 8, levels: int = 2, scheme: str = "cdf53", mode: str = "paper",
    device="cuda",
) -> Iterator[bytes]:
    """Stream-encode a volume as independent slabs along its leading axis:
    each ``x[i : i + slab]`` transforms as its own ``x.ndim``-D pyramid
    (levels clamped per slab, so a partial final slab encodes too), so no
    whole-volume pyramid or bitstream is ever resident."""
    x = np.asarray(x)
    if x.ndim < 2:
        raise ValueError(f"need a volume (>= 2 axes), got shape {x.shape}")
    if slab < 1:
        raise ValueError("slab must be >= 1")
    enc = StreamEncoder(levels=levels, scheme=scheme, mode=mode, ndim=x.ndim, device=device)
    return enc.encode(x[i : i + slab] for i in range(0, x.shape[0], slab))


def decode_volume(src: ByteSource, device="cuda") -> torch.Tensor:
    """Inverse of :func:`encode_volume`: concatenate decoded slabs."""
    slabs = list(decode_stream(src, device=device))
    if not slabs:
        raise CodecError("empty WZRS stream (no frames)")
    return torch.cat(slabs, dim=0)
