"""Progressive fidelity-tier routes over stored serve responses.

Port of ``repro.serve.routes``.  The engine ships each micro-batch as ONE
WZRC container; a response endpoint answers later fetches from that one
stored blob, each tier reading only the byte ranges it needs:

    thumbnail(uid)        the LL band for one request (header + one band
                          blob, no inverse transform)
    refine(uid, L)        the request reconstructed from the coarsest L
                          detail levels
    full(uid)             ``refine`` at the container's full level count:
                          the original samples, bit-exact

Tiers come back as tensors on the route's ``device`` (the card by
default), where the Rice decode kernel and the inverse transform run.
A padded request reconstructs at tier ``L`` to the bucket's
level-``(levels-L)`` shape and is cropped to its own ceil-halved shape
(:func:`tier_shape`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.codec import progressive
from repro_torch.serve.engine import TransformRequest

Shape = Tuple[int, ...]


class StoredResponse(NamedTuple):
    """One request's handle into a stored (possibly shared) container."""

    source: Any  # bytes or a pread() source for the WZRC container
    batch_index: Optional[int]  # row in a batch container; None = whole blob
    image_shape: Shape  # the request's ORIGINAL (pre-padding) shape


def tier_shape(image_shape: Shape, levels: int, up_to_level: int) -> Shape:
    """A request's shape at fidelity tier ``up_to_level``: the original
    shape ceil-halved ``levels - up_to_level`` times."""
    if not 0 <= up_to_level <= levels:
        raise ValueError(f"up_to_level must be in [0, {levels}], got {up_to_level}")
    k = levels - up_to_level
    return tuple(-(-s // (1 << k)) for s in image_shape)


@dataclass
class ProgressiveServeRoute:
    """Fidelity-tier responses from one stored bitstream per batch.

    ``store(req)`` files a served request's container handle;
    ``thumbnail`` / ``refine`` / ``full`` answer later fetches, decoding
    on ``device``.  ``heal`` / ``partial`` pass through to
    ``codec.progressive``.
    """

    device: Any = "cuda"
    _store: Dict[int, StoredResponse] = field(default_factory=dict)

    def store(self, req: TransformRequest) -> int:
        """File a served request's encoded response; returns its uid."""
        if req.encoded is None:
            raise ValueError(
                f"request {req.uid} has no encoded response "
                "(engine needs encode_response=True)"
            )
        self._store[req.uid] = StoredResponse(
            source=req.encoded, batch_index=req.batch_index, image_shape=tuple(req.image.shape),
        )
        return req.uid

    def put(
        self, uid: int, source: Any, *, batch_index: Optional[int] = None,
        image_shape: Optional[Shape] = None,
    ) -> None:
        """File a container handle directly (bytes or a pread source)."""
        if image_shape is None:
            image_shape = progressive.read_header(source).shape
        self._store[uid] = StoredResponse(source, batch_index, tuple(image_shape))

    def _entry(self, uid: int) -> StoredResponse:
        try:
            return self._store[uid]
        except KeyError:
            raise KeyError(f"no stored response for request {uid}") from None

    @staticmethod
    def _row(arr: torch.Tensor, entry: StoredResponse) -> torch.Tensor:
        return arr if entry.batch_index is None else arr[entry.batch_index]

    # -- tiers ---------------------------------------------------------------

    def thumbnail(self, uid: int, *, heal: bool = True) -> torch.Tensor:
        """The approximation band for ``uid`` — header + ONE band read."""
        entry = self._entry(uid)
        dec = progressive.decode_lowband(entry.source, heal=heal, device=self.device)
        crop = tier_shape(entry.image_shape, dec.levels, 0)
        return self._row(dec.band, entry)[tuple(slice(0, s) for s in crop)]

    def refine(
        self, uid: int, up_to_level: int, *, heal: bool = True, partial: bool = False,
    ) -> torch.Tensor:
        """``uid`` reconstructed from its coarsest ``up_to_level`` levels."""
        entry = self._entry(uid)
        h = progressive.read_header(entry.source)
        dec = progressive.decode_progressive(
            entry.source, up_to_level, heal=heal, partial=partial, device=self.device,
        )
        arr = self._row(progressive.reconstruct(dec), entry)
        crop = tier_shape(entry.image_shape, h.levels, up_to_level)
        return arr[tuple(slice(0, s) for s in crop)]

    def full(self, uid: int, *, heal: bool = True) -> torch.Tensor:
        """The original samples, bit-exact (every byte range read)."""
        entry = self._entry(uid)
        h = progressive.read_header(entry.source)
        return self.refine(uid, h.levels, heal=heal)

    def tiers(self, uid: int) -> Dict[int, Shape]:
        """Available fidelity tiers: ``{up_to_level: shape}`` for ``uid``."""
        entry = self._entry(uid)
        h = progressive.read_header(entry.source)
        return {lv: tier_shape(entry.image_shape, h.levels, lv) for lv in range(h.levels + 1)}
