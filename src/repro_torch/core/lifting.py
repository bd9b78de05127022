"""The 2-D integer lifting DWT oracle, on torch tensors.

Port of the 2-D part of ``repro.core.lifting``: one level over the last
two axes is the row transform (axis -1) followed by the column
transform (axis -2) of both row bands, band-policy math from
:mod:`repro_torch.core.schemes`; the multi-level forms recurse on LL
(the Mallat pyramid).  Every function runs on the device its input
lives on, and is the plain version the 2-D kernels are held against
(``kernels/ref.py``).

Dtype contract (:func:`promote_narrow`): int8, int16, uint8 and uint16
promote to int32; int32 passes through.  int64 is REJECTED: the
reference runs JAX with x64 disabled, which narrows int64 input to
int32 before lifting, while torch would lift it natively in int64 — so
neither choice would silently match.  Callers cast to int32 explicitly.

The 1-D and N-D transforms and ``checked=`` range certification are not
ported yet (``ROADMAP.md``, Queue 1).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import schemes as S
from repro_torch.core.schemes import (  # noqa: F401  re-exported registry surface
    LiftingScheme,
    LiftStep,
    available_schemes,
    get_scheme,
    register_scheme,
)

Tensor = torch.Tensor

_check_mode = S.check_mode

_NARROW = (torch.int8, torch.int16, torch.uint8, torch.uint16)
_WIDE_UNSIGNED = (torch.uint32, torch.uint64)


def promote_narrow(x: Tensor) -> Tensor:
    """Promote to int32 where the lifting sums need it: int8 / int16 /
    uint8 / uint16 -> int32, int32 unchanged.  Wide unsigned dtypes are
    rejected (``>>`` would be a logical shift, wrapping the negative
    detail bands) and so is int64 (see the module docstring)."""
    if x.dtype == torch.int32:
        return x
    if x.dtype in _NARROW:
        return x.to(torch.int32)
    if x.dtype == torch.int64:
        raise TypeError(
            "integer DWT computes in int32; int64 input is rejected (the "
            "reference narrows it to int32, torch would not) — cast with "
            ".to(torch.int32) first"
        )
    if x.dtype in _WIDE_UNSIGNED:
        raise TypeError(
            f"integer DWT requires a signed (or narrow unsigned) dtype, "
            f"got {x.dtype}: detail bands are signed"
        )
    raise TypeError(f"integer DWT requires an integer dtype, got {x.dtype}")


# ---------------------------------------------------------------------------
# One 2-D level (rows then columns).
# ---------------------------------------------------------------------------


class Bands2D(NamedTuple):
    ll: Tensor
    lh: Tensor
    hl: Tensor
    hh: Tensor


def dwt_fwd_2d(x: Tensor, mode: str = "paper", scheme="cdf53") -> Bands2D:
    """One 2-D level over the last two axes: rows then columns."""
    xf = promote_narrow(x)
    s_r, d_r = S.lift_fwd_axis(xf, scheme, axis=-1, mode=mode)
    ll, lh = S.lift_fwd_axis(s_r, scheme, axis=-2, mode=mode)
    hl, hh = S.lift_fwd_axis(d_r, scheme, axis=-2, mode=mode)
    return Bands2D(ll=ll, lh=lh, hl=hl, hh=hh)


def dwt_inv_2d(bands: Bands2D, mode: str = "paper", scheme="cdf53") -> Tensor:
    """Inverse of :func:`dwt_fwd_2d` (columns then rows)."""
    ll, lh, hl, hh = (promote_narrow(b) for b in bands)
    s_r = S.lift_inv_axis(ll, lh, scheme, axis=-2, mode=mode)
    d_r = S.lift_inv_axis(hl, hh, scheme, axis=-2, mode=mode)
    return S.lift_inv_axis(s_r, d_r, scheme, axis=-1, mode=mode)


# ---------------------------------------------------------------------------
# Multi-level pyramid.
# ---------------------------------------------------------------------------


class Pyramid2D(NamedTuple):
    """Multi-level 2-D (Mallat) decomposition.

    ``ll`` is the coarsest approximation; ``details[0]`` is the COARSEST
    level's (lh, hl, hh) triple.
    """

    ll: Any
    details: Tuple[Tuple[Any, Any, Any], ...]  # coarsest first

    @property
    def levels(self) -> int:
        return len(self.details)

    @classmethod
    def from_numpy(cls, pyr, device="cpu") -> "Pyramid2D":
        """A tensor pyramid from any object with ``ll`` / ``details``
        whose leaves convert with ``np.asarray`` (a reference pyramid,
        or the result of :meth:`to_numpy`)."""

        def t(a) -> Tensor:
            return torch.from_numpy(np.array(a, copy=True)).to(device)

        return cls(
            ll=t(pyr.ll),
            details=tuple(tuple(t(b) for b in lvl) for lvl in pyr.details),
        )

    def to_numpy(self) -> "Pyramid2D":
        """The same pyramid with host numpy leaves."""

        def a(t: Tensor) -> np.ndarray:
            return t.detach().cpu().numpy()

        return Pyramid2D(
            ll=a(self.ll),
            details=tuple(tuple(a(b) for b in lvl) for lvl in self.details),
        )


def check_levels_2d(h: int, w: int, levels: int) -> None:
    """Raise unless a (h, w) image supports `levels` 2-D decompositions."""
    if levels < 0:
        raise ValueError("levels must be >= 0")
    for _ in range(levels):
        if h < 2 or w < 2:
            raise ValueError(f"image too small for {levels} 2D levels (h={h}, w={w})")
        h, w = h - h // 2, w - w // 2


def dwt_fwd_2d_multi(
    x: Tensor, levels: int = 1, mode: str = "paper", scheme="cdf53"
) -> Pyramid2D:
    """Multi-level 2-D forward transform (Mallat pyramid, recurse on LL)."""
    check_levels_2d(x.shape[-2], x.shape[-1], levels)
    ll = promote_narrow(x)
    details: List[Tuple[Tensor, Tensor, Tensor]] = []
    for _ in range(levels):
        bands = dwt_fwd_2d(ll, mode=mode, scheme=scheme)
        ll = bands.ll
        details.append((bands.lh, bands.hl, bands.hh))
    return Pyramid2D(ll=ll, details=tuple(reversed(details)))


def dwt_inv_2d_multi(pyr: Pyramid2D, mode: str = "paper", scheme="cdf53") -> Tensor:
    """Inverse of :func:`dwt_fwd_2d_multi`."""
    ll = promote_narrow(pyr.ll)
    for lh, hl, hh in pyr.details:  # coarsest first
        ll = dwt_inv_2d(Bands2D(ll=ll, lh=lh, hl=hl, hh=hh), mode=mode, scheme=scheme)
    return ll


# ---------------------------------------------------------------------------
# Band geometry and flat packing.  Band shapes are scheme-independent:
# len(s) = ceil(N/2), len(d) = floor(N/2) along each axis.
# ---------------------------------------------------------------------------


def band_shapes_2d(
    h: int, w: int, levels: int
) -> Tuple[Tuple[int, int], Tuple[Tuple[Tuple[int, int], ...], ...]]:
    """(ll_shape, per-level (lh, hl, hh) shapes coarsest-first) for (h, w)."""
    shapes = []
    for _ in range(levels):
        h_e, w_e = h - h // 2, w - w // 2
        h_o, w_o = h // 2, w // 2
        shapes.append(((h_o, w_e), (h_e, w_o), (h_o, w_o)))
        h, w = h_e, w_e
    return (h, w), tuple(reversed(shapes))


def pack2d(pyr: Pyramid2D) -> Tensor:
    """Flatten [ll, then per-level lh, hl, hh coarsest->finest] along -1."""
    lead = tuple(pyr.ll.shape[:-2])

    def flat(a: Tensor) -> Tensor:
        return a.reshape(lead + (a.shape[-2] * a.shape[-1],))

    parts = [flat(pyr.ll)]
    for lh, hl, hh in pyr.details:
        parts.extend([flat(lh), flat(hl), flat(hh)])
    return torch.cat(parts, dim=-1)


def unpack2d(flat: Tensor, h: int, w: int, levels: int) -> Pyramid2D:
    """Inverse of :func:`pack2d` for an original (h, w) image."""
    ll_shape, det_shapes = band_shapes_2d(h, w, levels)
    lead = tuple(flat.shape[:-1])
    off = 0

    def take(shape: Tuple[int, int]) -> Tensor:
        nonlocal off
        n = shape[0] * shape[1]
        part = flat[..., off : off + n]
        off += n
        return part.reshape(lead + shape)

    ll = take(ll_shape)
    details = tuple(
        (take(sh_lh), take(sh_hl), take(sh_hh)) for sh_lh, sh_hl, sh_hh in det_shapes
    )
    return Pyramid2D(ll=ll, details=details)


def max_levels_2d(h: int, w: int) -> int:
    """Deepest 2-D decomposition with >= 2 samples per axis at every level
    (0 for degenerate images)."""
    lv = 0
    while h >= 2 and w >= 2:
        h, w = h - h // 2, w - w // 2
        lv += 1
        if h < 2 or w < 2:
            break
    return lv
