"""The integer lifting DWT oracle, on torch tensors: 1-D and 2-D.

Port of the 1-D and 2-D parts of ``repro.core.lifting``.  A 1-D level
is the band-policy lifting cascade along the last axis
(:mod:`repro_torch.core.schemes`); one 2-D level is the row transform
(axis -1) followed by the column transform (axis -2) of both row bands;
the multi-level forms recurse on the approximation (the Mallat
pyramid).  Every function runs on the device its input lives on, and is
the plain version the kernels are held against (``kernels/ref.py``).

Dtype contract (:func:`promote_narrow`): int8, int16, uint8 and uint16
promote to int32; int32 passes through.  int64 is REJECTED: the
reference runs JAX with x64 disabled, which narrows int64 input to
int32 before lifting, while torch would lift it natively in int64 — so
neither choice would silently match.  Callers cast to int32 explicitly.

The N-D part (:class:`PyramidND`, :func:`dwt_fwd_nd` /
:func:`dwt_inv_nd`, :func:`pack_nd` / :func:`unpack_nd`) transforms the
last ``ndim`` axes, one axis at a time per level: axis -1 first, so
ndim 1 and 2 reproduce the 1-D and 2-D transforms bit for bit; bit j of
a band's code means highpass along axis -(j+1).  It is the plain
version of the 3-D kernels (``kernels/fused3d.py``).

Every transform here takes ``checked=`` as the reference's does:
``checked=True`` (or ``REPRO_DWT_CHECKED=1``) certifies the data against
the derived range bounds (:mod:`repro_torch.core.ranges`) and raises
``IntegerOverflowError`` instead of ever returning wrapped bands.  The
``dwt53_*`` aliases pass ``checked=`` through.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ranges as _ranges
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


def _shift_down(x: Tensor, k: int) -> Tensor:
    """floor(x / 2**k) as an arithmetic right shift (multiplierless)."""
    if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
        raise TypeError(f"integer DWT requires an integer dtype, got {x.dtype}")
    return torch.bitwise_right_shift(x, k)


# ---------------------------------------------------------------------------
# The paper's (5,3) operators, verbatim — the hardware-model reference.
# ---------------------------------------------------------------------------


def predict(even: Tensor, even_next: Tensor, odd: Tensor) -> Tensor:
    """eq. (5): d[n] = odd[n] - floor((even[n] + even[n+1]) / 2)."""
    return odd - _shift_down(even + even_next, 1)


def update(even: Tensor, d: Tensor, d_prev: Tensor, mode: str = "paper") -> Tensor:
    """eq. (7): s[n] = even[n] + floor((d[n] + d[n-1]) / 4) (paper mode);
    jpeg2000 mode adds the +2 offset before the shift."""
    _check_mode(mode)
    t = d + d_prev
    if mode == "jpeg2000":
        t = t + 2
    return even + _shift_down(t, 2)


def inv_update(s: Tensor, d: Tensor, d_prev: Tensor, mode: str = "paper") -> Tensor:
    """eq. (8): even[n] = s[n] - floor((d[n] + d[n-1]) / 4) (+2 offset in
    jpeg2000 mode) — the structural inverse of :func:`update`."""
    _check_mode(mode)
    t = d + d_prev
    if mode == "jpeg2000":
        t = t + 2
    return s - _shift_down(t, 2)


# ---------------------------------------------------------------------------
# 1-D transform along the last axis (any registered scheme).
# ---------------------------------------------------------------------------


def dwt_fwd_1d(
    x: Tensor, mode: str = "paper", scheme="cdf53", checked=None
) -> Tuple[Tensor, Tensor]:
    """One forward lifting level along the last axis: (s, d) with
    len(s) = ceil(N/2), len(d) = floor(N/2); any N >= 2."""
    _check_mode(mode)
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked(
            lambda a: dwt_fwd_1d(a, mode=mode, scheme=scheme, checked=False),
            x, scheme=scheme, levels=1, mode=mode, ndim=1, label="lifting.dwt_fwd_1d",
        )
    return S.lift_fwd_axis(promote_narrow(x), scheme, axis=-1, mode=mode)


def dwt_inv_1d(s: Tensor, d: Tensor, mode: str = "paper", scheme="cdf53", checked=None) -> Tensor:
    """One inverse lifting level (cdf53: eqs. 8-10) along the last axis."""
    _check_mode(mode)
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked_inv(
            lambda t: dwt_inv_1d(t[0], t[1], mode=mode, scheme=scheme, checked=False),
            (s, d), scheme=scheme, levels=1, mode=mode, ndim=1, label="lifting.dwt_inv_1d",
        )
    return S.lift_inv_axis(promote_narrow(s), promote_narrow(d), scheme, axis=-1, mode=mode)


# ---------------------------------------------------------------------------
# One 2-D level (rows then columns).
# ---------------------------------------------------------------------------


class Bands2D(NamedTuple):
    ll: Tensor
    lh: Tensor
    hl: Tensor
    hh: Tensor


def dwt_fwd_2d(x: Tensor, mode: str = "paper", scheme="cdf53", checked=None) -> Bands2D:
    """One 2-D level over the last two axes: rows then columns."""
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked(
            lambda a: dwt_fwd_2d(a, mode=mode, scheme=scheme, checked=False),
            x, scheme=scheme, levels=1, mode=mode, ndim=2, label="lifting.dwt_fwd_2d",
        )
    xf = promote_narrow(x)
    s_r, d_r = S.lift_fwd_axis(xf, scheme, axis=-1, mode=mode)
    ll, lh = S.lift_fwd_axis(s_r, scheme, axis=-2, mode=mode)
    hl, hh = S.lift_fwd_axis(d_r, scheme, axis=-2, mode=mode)
    return Bands2D(ll=ll, lh=lh, hl=hl, hh=hh)


def dwt_inv_2d(bands: Bands2D, mode: str = "paper", scheme="cdf53", checked=None) -> Tensor:
    """Inverse of :func:`dwt_fwd_2d` (columns then rows)."""
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked_inv(
            lambda b: dwt_inv_2d(b, mode=mode, scheme=scheme, checked=False),
            bands, scheme=scheme, levels=1, mode=mode, ndim=2, label="lifting.dwt_inv_2d",
        )
    ll, lh, hl, hh = (promote_narrow(b) for b in bands)
    s_r = S.lift_inv_axis(ll, lh, scheme, axis=-2, mode=mode)
    d_r = S.lift_inv_axis(hl, hh, scheme, axis=-2, mode=mode)
    return S.lift_inv_axis(s_r, d_r, scheme, axis=-1, mode=mode)


# ---------------------------------------------------------------------------
# Multi-level pyramid.
# ---------------------------------------------------------------------------


def _to_tensor(a, device) -> Tensor:
    from repro_torch.kernels.backend import resolve_device

    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def _to_array(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


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
    def from_numpy(cls, pyr, device="cuda") -> "Pyramid2D":
        """A tensor pyramid from any object with ``ll`` / ``details``
        whose leaves convert with ``np.asarray`` (a reference pyramid,
        or the result of :meth:`to_numpy`), on ``device`` — the card by
        default, raising without one; ``device="cpu"`` for the CPU."""
        return cls(
            ll=_to_tensor(pyr.ll, device),
            details=tuple(tuple(_to_tensor(b, device) for b in lvl) for lvl in pyr.details),
        )

    def to_numpy(self) -> "Pyramid2D":
        """The same pyramid with host numpy leaves."""
        return Pyramid2D(
            ll=_to_array(self.ll),
            details=tuple(tuple(_to_array(b) for b in lvl) for lvl in self.details),
        )


class WaveletPyramid(NamedTuple):
    """Multi-level 1-D decomposition: approx band + details, coarsest first."""

    approx: Any
    details: Tuple[Any, ...]  # details[0] is the COARSEST level

    @property
    def levels(self) -> int:
        return len(self.details)

    @classmethod
    def from_numpy(cls, pyr, device="cuda") -> "WaveletPyramid":
        """A tensor pyramid from any object with ``approx`` / ``details``
        (a reference pyramid, or the result of :meth:`to_numpy`), on
        ``device`` — the card by default, raising without one."""
        return cls(
            approx=_to_tensor(pyr.approx, device),
            details=tuple(_to_tensor(d, device) for d in pyr.details),
        )

    def to_numpy(self) -> "WaveletPyramid":
        """The same pyramid with host numpy leaves."""
        return WaveletPyramid(
            approx=_to_array(self.approx),
            details=tuple(_to_array(d) for d in self.details),
        )


def dwt_fwd(
    x: Tensor, levels: int = 1, mode: str = "paper", scheme="cdf53", checked=None
) -> "WaveletPyramid":
    """Multi-level 1-D forward transform along the last axis.  ``levels=0``
    is the identity pyramid (no detail bands)."""
    if levels < 0:
        raise ValueError("levels must be >= 0")
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked(
            lambda a: dwt_fwd(a, levels=levels, mode=mode, scheme=scheme, checked=False),
            x, scheme=scheme, levels=levels, mode=mode, ndim=1, label="lifting.dwt_fwd",
        )
    s = promote_narrow(x)
    details: List[Tensor] = []
    for _ in range(levels):
        if s.shape[-1] < 2:
            raise ValueError(f"signal too short for {levels} levels (got {x.shape[-1]})")
        s, d = S.lift_fwd_axis(s, scheme, axis=-1, mode=mode)
        details.append(d)
    return WaveletPyramid(approx=s, details=tuple(reversed(details)))


def dwt_inv(pyr: "WaveletPyramid", mode: str = "paper", scheme="cdf53", checked=None) -> Tensor:
    """Multi-level 1-D inverse transform."""
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked_inv(
            lambda p: dwt_inv(p, mode=mode, scheme=scheme, checked=False),
            pyr, scheme=scheme, levels=pyr.levels, mode=mode, ndim=1, label="lifting.dwt_inv",
        )
    s = promote_narrow(pyr.approx)
    for d in pyr.details:  # coarsest first
        s = S.lift_inv_axis(s, promote_narrow(d), scheme, axis=-1, mode=mode)
    return s


def dwt53_fwd_1d(x: Tensor, mode: str = "paper", checked=None) -> Tuple[Tensor, Tensor]:
    """(5,3) forward level: :func:`dwt_fwd_1d` with ``scheme="cdf53"``."""
    return dwt_fwd_1d(x, mode=mode, scheme="cdf53", checked=checked)


def dwt53_inv_1d(s: Tensor, d: Tensor, mode: str = "paper", checked=None) -> Tensor:
    return dwt_inv_1d(s, d, mode=mode, scheme="cdf53", checked=checked)


def dwt53_fwd(x: Tensor, levels: int = 1, mode: str = "paper", checked=None) -> "WaveletPyramid":
    return dwt_fwd(x, levels=levels, mode=mode, scheme="cdf53", checked=checked)


def dwt53_inv(pyr: "WaveletPyramid", mode: str = "paper", checked=None) -> Tensor:
    return dwt_inv(pyr, mode=mode, scheme="cdf53", checked=checked)


class PyramidND(NamedTuple):
    """Multi-level N-D (Mallat) decomposition.

    ``approx`` is the coarsest all-lowpass band; ``details[0]`` is the
    COARSEST level's tuple of ``2**ndim - 1`` detail bands in band-code
    order (bit j of the code = highpass along axis -(j+1)).
    """

    approx: Any
    details: Tuple[Tuple[Any, ...], ...]  # coarsest first

    @property
    def levels(self) -> int:
        return len(self.details)

    @property
    def ndim(self) -> int:
        """Number of transformed trailing axes (from the band count)."""
        if not self.details:
            raise ValueError("levels=0 pyramid carries no bands; ndim is undefined")
        n_bands = len(self.details[0]) + 1
        nd = n_bands.bit_length() - 1
        if 1 << nd != n_bands:
            raise ValueError(
                f"malformed PyramidND: {n_bands - 1} detail bands per "
                "level is not 2**ndim - 1"
            )
        return nd

    @classmethod
    def from_numpy(cls, pyr, device="cuda") -> "PyramidND":
        """A tensor pyramid from any object with ``approx`` / ``details``
        (a reference pyramid, or the result of :meth:`to_numpy`), on
        ``device`` — the card by default, raising without one."""
        return cls(
            approx=_to_tensor(pyr.approx, device),
            details=tuple(tuple(_to_tensor(b, device) for b in lvl) for lvl in pyr.details),
        )

    def to_numpy(self) -> "PyramidND":
        """The same pyramid with host numpy leaves."""
        return PyramidND(
            approx=_to_array(self.approx),
            details=tuple(tuple(_to_array(b) for b in lvl) for lvl in self.details),
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
    x: Tensor, levels: int = 1, mode: str = "paper", scheme="cdf53", checked=None
) -> Pyramid2D:
    """Multi-level 2-D forward transform (Mallat pyramid, recurse on LL)."""
    check_levels_2d(x.shape[-2], x.shape[-1], levels)
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked(
            lambda a: dwt_fwd_2d_multi(a, levels=levels, mode=mode, scheme=scheme,
                                       checked=False),
            x, scheme=scheme, levels=levels, mode=mode, ndim=2,
            label="lifting.dwt_fwd_2d_multi",
        )
    ll = promote_narrow(x)
    details: List[Tuple[Tensor, Tensor, Tensor]] = []
    for _ in range(levels):
        bands = dwt_fwd_2d(ll, mode=mode, scheme=scheme, checked=False)
        ll = bands.ll
        details.append((bands.lh, bands.hl, bands.hh))
    return Pyramid2D(ll=ll, details=tuple(reversed(details)))


def dwt_inv_2d_multi(
    pyr: Pyramid2D, mode: str = "paper", scheme="cdf53", checked=None
) -> Tensor:
    """Inverse of :func:`dwt_fwd_2d_multi`."""
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked_inv(
            lambda p: dwt_inv_2d_multi(p, mode=mode, scheme=scheme, checked=False),
            pyr, scheme=scheme, levels=pyr.levels, mode=mode, ndim=2,
            label="lifting.dwt_inv_2d_multi",
        )
    ll = promote_narrow(pyr.ll)
    for lh, hl, hh in pyr.details:  # coarsest first
        ll = dwt_inv_2d(Bands2D(ll=ll, lh=lh, hl=hl, hh=hh), mode=mode, scheme=scheme,
                        checked=False)
    return ll


def dwt53_fwd_2d(x: Tensor, mode: str = "paper", checked=None) -> Bands2D:
    return dwt_fwd_2d(x, mode=mode, scheme="cdf53", checked=checked)


def dwt53_inv_2d(bands: Bands2D, mode: str = "paper", checked=None) -> Tensor:
    return dwt_inv_2d(bands, mode=mode, scheme="cdf53", checked=checked)


def dwt53_fwd_2d_multi(
    x: Tensor, levels: int = 1, mode: str = "paper", checked=None
) -> Pyramid2D:
    return dwt_fwd_2d_multi(x, levels=levels, mode=mode, scheme="cdf53", checked=checked)


def dwt53_inv_2d_multi(pyr: Pyramid2D, mode: str = "paper", checked=None) -> Tensor:
    return dwt_inv_2d_multi(pyr, mode=mode, scheme="cdf53", checked=checked)


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


def band_sizes(n: int, levels: int) -> Tuple[int, Tuple[int, ...]]:
    """(approx_len, detail_lens coarsest-first) for a length-n signal."""
    sizes = []
    cur = n
    for _ in range(levels):
        d_len = cur // 2
        cur = cur - d_len  # ceil(cur/2)
        sizes.append(d_len)
    return cur, tuple(reversed(sizes))


def pack(pyr: WaveletPyramid) -> Tensor:
    """Concatenate [approx, details coarsest->finest] along the last axis."""
    return torch.cat((pyr.approx,) + tuple(pyr.details), dim=-1)


def unpack(flat: Tensor, n: int, levels: int) -> WaveletPyramid:
    """Inverse of :func:`pack` for an original signal length n."""
    a_len, d_lens = band_sizes(n, levels)
    details = []
    off = a_len
    for dl in d_lens:
        details.append(flat[..., off : off + dl])
        off += dl
    return WaveletPyramid(approx=flat[..., :a_len], details=tuple(details))


def max_levels(n: int) -> int:
    """Deepest decomposition such that every level has >= 2 samples
    (0 for n < 2)."""
    lv = 0
    while n >= 2:
        n = n - n // 2
        lv += 1
        if n < 2:
            break
    return lv


def max_levels_nd(shape: Tuple[int, ...]) -> int:
    """Deepest N-D decomposition with >= 2 samples on EVERY axis per level
    (0 when any axis is degenerate)."""
    dims = list(shape)
    lv = 0
    while dims and all(n >= 2 for n in dims):
        dims = [n - n // 2 for n in dims]
        lv += 1
        if any(n < 2 for n in dims):
            break
    return lv


def band_shapes_nd(
    shape: Tuple[int, ...], levels: int
) -> Tuple[Tuple[int, ...], Tuple[Tuple[Tuple[int, ...], ...], ...]]:
    """(approx_shape, per-level detail shapes coarsest-first, code order).

    Bit j of a band code is highpass along axis -(j+1); every scheme keeps
    the lazy-wavelet split len(s) = ceil(n/2), len(d) = floor(n/2).
    """
    ndim = len(shape)
    dims = list(shape)
    per_level = []
    for _ in range(levels):
        evens = [n - n // 2 for n in dims]
        odds = [n // 2 for n in dims]
        lvl = []
        for code in range(1, 1 << ndim):
            lvl.append(
                tuple(
                    odds[i] if (code >> (ndim - 1 - i)) & 1 else evens[i]
                    for i in range(ndim)
                )
            )
        per_level.append(tuple(lvl))
        dims = evens
    return tuple(dims), tuple(reversed(per_level))


# ---------------------------------------------------------------------------
# The N-D transform: one level per axis, axis -1 first.
# ---------------------------------------------------------------------------


def _fwd_nd_level(x: Tensor, ndim: int, mode: str, scheme) -> List[Tensor]:
    """One N-D level: the ``2**ndim`` bands in code order (code 0 is the
    approximation; bit j of the code = highpass along axis -(j+1))."""
    bands = [x]
    for j in range(ndim):  # axis -1 first, matching the 2-D composition
        nxt: List[Tensor] = [None] * (2 * len(bands))  # type: ignore[list-item]
        for code, b in enumerate(bands):
            s, d = S.lift_fwd_axis(b, scheme, axis=-(j + 1), mode=mode)
            nxt[code] = s
            nxt[code | (1 << j)] = d
        bands = nxt
    return bands


def _inv_nd_level(bands: List[Tensor], ndim: int, mode: str, scheme) -> Tensor:
    """Structural inverse of :func:`_fwd_nd_level` (axes in reverse)."""
    cur = list(bands)
    for j in reversed(range(ndim)):
        half = 1 << j
        cur = [
            S.lift_inv_axis(cur[code], cur[code | half], scheme, axis=-(j + 1), mode=mode)
            for code in range(half)
        ]
    return cur[0]


def check_levels_nd(shape: Tuple[int, ...], levels: int) -> None:
    """Raise unless the trailing ``shape`` supports ``levels`` N-D levels."""
    if levels < 0:
        raise ValueError("levels must be >= 0")
    dims = list(shape)
    if not dims:
        raise ValueError("need at least one transform axis")
    for _ in range(levels):
        if any(n < 2 for n in dims):
            raise ValueError(f"shape {tuple(shape)} too small for {levels} N-D levels")
        dims = [n - n // 2 for n in dims]


def dwt_fwd_nd(
    x: Tensor, levels: int = 1, mode: str = "paper", scheme="cdf53", ndim: int = 3,
    checked=None,
) -> PyramidND:
    """Multi-level N-D forward transform over the last ``ndim`` axes.

    ``levels=0`` is the identity pyramid (no detail bands).  ndim 1 and 2
    reproduce the 1-D and 2-D transforms bit for bit.  ``checked=True``
    (or ``REPRO_DWT_CHECKED=1``) certifies the data first and raises
    ``IntegerOverflowError`` instead of returning wrapped bands.
    """
    if ndim < 1:
        raise ValueError(f"ndim must be >= 1, got {ndim}")
    if x.ndim < ndim:
        raise ValueError(f"need >= {ndim} axes, got shape {tuple(x.shape)}")
    check_levels_nd(tuple(x.shape[-ndim:]), levels)
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked(
            lambda a: dwt_fwd_nd(a, levels=levels, mode=mode, scheme=scheme, ndim=ndim,
                                 checked=False),
            x, scheme=scheme, levels=levels, mode=mode, ndim=ndim, label="lifting.dwt_fwd_nd",
        )
    approx = promote_narrow(x)
    details: List[Tuple[Tensor, ...]] = []
    for _ in range(levels):
        bands = _fwd_nd_level(approx, ndim, mode, scheme)
        approx = bands[0]
        details.append(tuple(bands[1:]))
    return PyramidND(approx=approx, details=tuple(reversed(details)))


def dwt_inv_nd(pyr: PyramidND, mode: str = "paper", scheme="cdf53", checked=None) -> Tensor:
    """Inverse of :func:`dwt_fwd_nd`."""
    if pyr.details and _ranges.checked_enabled(checked):
        return _ranges.run_checked_inv(
            lambda p: dwt_inv_nd(p, mode=mode, scheme=scheme, checked=False),
            pyr, scheme=scheme, levels=pyr.levels, mode=mode, ndim=pyr.ndim,
            label="lifting.dwt_inv_nd",
        )
    approx = promote_narrow(pyr.approx)
    if not pyr.details:
        return approx
    ndim = pyr.ndim
    for lvl in pyr.details:  # coarsest first
        approx = _inv_nd_level([approx] + [promote_narrow(b) for b in lvl], ndim, mode, scheme)
    return approx


def pack_nd(pyr: PyramidND, ndim: Optional[int] = None) -> Tensor:
    """Flatten [approx, then per-level detail bands coarsest->finest, code
    order] along the last axis (the N-D analogue of :func:`pack2d`).

    ``ndim`` is derived from the band structure; a levels=0 identity
    pyramid carries no bands, so it must be passed explicitly there.
    """
    if pyr.details:
        nd = pyr.ndim
        if ndim is not None and ndim != nd:
            raise ValueError(f"ndim={ndim} but pyramid has ndim={nd}")
    elif ndim is None:
        raise ValueError("levels=0 pyramid: pass ndim explicitly")
    else:
        nd = ndim
    lead = tuple(pyr.approx.shape[:-nd])

    def flat(a: Tensor) -> Tensor:
        return a.reshape(lead + (int(np.prod(a.shape[-nd:])),))

    parts = [flat(pyr.approx)]
    for lvl in pyr.details:
        parts.extend(flat(b) for b in lvl)
    return torch.cat(parts, dim=-1)


def unpack_nd(flat: Tensor, shape: Tuple[int, ...], levels: int) -> PyramidND:
    """Inverse of :func:`pack_nd` for an original trailing ``shape``."""
    a_shape, det_shapes = band_shapes_nd(tuple(shape), levels)
    lead = tuple(flat.shape[:-1])
    off = 0

    def take(shp: Tuple[int, ...]) -> Tensor:
        nonlocal off
        n = int(np.prod(shp))
        part = flat[..., off : off + n]
        off += n
        return part.reshape(lead + tuple(shp))

    approx = take(a_shape)
    details = tuple(tuple(take(shp) for shp in lvl) for lvl in det_shapes)
    return PyramidND(approx=approx, details=details)


# ---------------------------------------------------------------------------
# Direct-form (5,3) filterbank — the baseline the paper compares against
# (Table 2 / "standard methods require 8 operations").
# ---------------------------------------------------------------------------

# LeGall/CDF 5/3 analysis filters (float, for the Table 3 float baseline).
H_LO = torch.tensor([-1 / 8, 2 / 8, 6 / 8, 2 / 8, -1 / 8], dtype=torch.float32)
H_HI = torch.tensor([-1 / 2, 1.0, -1 / 2], dtype=torch.float32)


def filterbank53_fwd_float(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Direct-form float (5,3) analysis: convolve + downsample.

    This is the paper's comparison baseline (standard filterbank, 8 ops,
    floating point).  Not integer-lossless; used only for op-count and
    timing comparisons.  The plain version of the one-launch kernel
    ``kernels.filterbank53_fwd_float`` (``csrc/filterbank.cu``): every
    product and sum is rounded once, in this order, on either device.
    Needs at least 3 samples (the extension by 2 reads ``x[..., 1:3]``).
    """
    xf = x.to(torch.float32)
    n = xf.shape[-1]
    if n < 3:
        raise ValueError(f"the float filterbank needs at least 3 samples, got {n}")
    # whole-point symmetric extension by 2 on both sides
    left = xf[..., 1:3].flip(-1)
    right = xf[..., -3:-1].flip(-1)
    ext = torch.cat([left, xf, right], dim=-1)

    def conv(sig: Tensor, taps: Tensor) -> Tensor:
        k = taps.shape[0]
        cols = [sig[..., i : i + n] for i in range(k)]
        acc = cols[0] * taps[0]
        for i in range(1, k):
            acc = acc + cols[i] * taps[i]
        return acc

    lo = conv(ext, H_LO)  # lo[j] centered at x[j]
    hi = conv(ext[..., 2:], H_HI)  # hi[j] centered at x[j+1]
    s = lo[..., 0::2]
    d = hi[..., 0::2][..., : n // 2]  # centers 1, 3, 5, ...
    return s, d
