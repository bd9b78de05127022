"""Plain NumPy reference of the reversible 5/3 (LeGall) integer wavelet.

ISO/IEC 15444-1 Annex F, the reversible path of JPEG 2000 Part 1, and
its 3-D extension of Part 10 (JP3D):

    d[i] = x[2i+1] - floor((x[2i] + x[2i+2]) / 2)          predict
    s[i] = x[2i]   + floor((d[i-1] + d[i] + 2) / 4)        update

with whole-point symmetric extension at both ends (x[-1] = x[1],
x[n] = x[n-2]), so a length-n axis gives ceil(n/2) low and floor(n/2)
high samples.  One level of an N-D transform lifts the last axis first,
then each earlier axis, over every band made so far; band code bit j
marks the high half along axis -(j+1).  A pyramid is the coarsest
approximation and, coarsest level first, each level's 2**ndim - 1 detail
bands in code order; for ndim 2 in Mallat order (lh, hl, hh) instead:
high along the columns, along the rows, along both (codes 2, 1, 3).

The benchmark judges the port with this file alone: it imports nothing
but NumPy and works each batch out again from the inputs it was given,
one image or volume at a time.  ``dtype`` sets the integer type every
step is computed in (the configuration's int32; a narrower type is the
precision control).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _fwd_axis(x: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """One forward lifting level along ``axis``: (low, high)."""
    v = np.moveaxis(x, axis, 0)
    n = v.shape[0]
    if n < 2:
        raise ValueError(f"axis of length {n} cannot be lifted")
    even, odd = v[0::2], v[1::2]
    ne, no = even.shape[0], odd.shape[0]
    right = even[1:] if ne > no else np.concatenate([even[1:], even[-1:]])
    one, two = x.dtype.type(1), x.dtype.type(2)
    d = odd - ((even[:no] + right) >> one)
    prev = np.concatenate([d[:1], d[:-1]])
    cur = d
    if ne > no:  # odd length: the last low sample's right neighbour reflects to d[-1]
        prev = np.concatenate([prev, d[-1:]])
        cur = np.concatenate([d, d[-1:]])
    s = even + ((prev + cur + two) >> two)
    return np.moveaxis(s, 0, axis), np.moveaxis(d, 0, axis)


def _inv_axis(s: np.ndarray, d: np.ndarray, axis: int) -> np.ndarray:
    """Inverse of :func:`_fwd_axis`."""
    sv, dv = np.moveaxis(s, axis, 0), np.moveaxis(d, axis, 0)
    ne, no = sv.shape[0], dv.shape[0]
    one, two = s.dtype.type(1), s.dtype.type(2)
    prev = np.concatenate([dv[:1], dv[:-1]])
    cur = dv
    if ne > no:
        prev = np.concatenate([prev, dv[-1:]])
        cur = np.concatenate([dv, dv[-1:]])
    even = sv - ((prev + cur + two) >> two)
    right = even[1:] if ne > no else np.concatenate([even[1:], even[-1:]])
    odd = dv + ((even[:no] + right) >> one)
    out = np.empty((ne + no,) + sv.shape[1:], s.dtype)
    out[0::2], out[1::2] = even, odd
    return np.moveaxis(out, 0, axis)


def fwd_level(x: np.ndarray, ndim: int) -> List[np.ndarray]:
    """One N-D level over the last ``ndim`` axes: the 2**ndim bands in
    code order (code 0 the approximation)."""
    bands = [x]
    for j in range(ndim):
        nxt: List[np.ndarray] = [None] * (2 * len(bands))  # type: ignore[list-item]
        for code, b in enumerate(bands):
            nxt[code], nxt[code | (1 << j)] = _fwd_axis(b, -(j + 1))
        bands = nxt
    return bands


def inv_level(bands: Sequence[np.ndarray], ndim: int) -> np.ndarray:
    """Inverse of :func:`fwd_level`."""
    cur = list(bands)
    for j in reversed(range(ndim)):
        half = 1 << j
        cur = [_inv_axis(cur[c], cur[c | half], -(j + 1)) for c in range(half)]
    return cur[0]


def _detail_codes(ndim: int) -> Tuple[int, ...]:
    return (2, 1, 3) if ndim == 2 else tuple(range(1, 1 << ndim))


def forward(x: np.ndarray, levels: int, ndim: int, dtype=np.int32):
    """Multi-level forward transform of one image or volume ``x``:
    ``(approx, details)``, details coarsest level first."""
    approx = np.ascontiguousarray(x, dtype=dtype)
    details = []
    for _ in range(levels):
        bands = fwd_level(approx, ndim)
        approx = np.ascontiguousarray(bands[0])
        details.append(tuple(np.ascontiguousarray(bands[c]) for c in _detail_codes(ndim)))
    return approx, tuple(reversed(details))


def inverse(approx: np.ndarray, details, ndim: int) -> np.ndarray:
    """Inverse of :func:`forward`."""
    x = approx
    for lvl in details:
        bands = [x] + [None] * len(lvl)
        for c, b in zip(_detail_codes(ndim), lvl):
            bands[c] = b
        x = inv_level(bands, ndim)
    return np.ascontiguousarray(x)
