"""Certified integer range safety: derived overflow certificates.

Port of ``repro.core.ranges``.  Every predict/update step grows dynamic
range, so "which inputs are safe for (scheme, levels, ndim) in dtype
d?" is derivable from the :class:`~repro_torch.core.schemes.LiftStep`
specs, exactly like the Table-2 adder/shifter ledgers.  This module is
that derivation plus the runtime machinery built on it:

  * :func:`trace_forward` / :func:`trace_inverse` — exact interval
    arithmetic over the resolved step cascade, in arbitrary-precision
    Python integers, mirroring the engine evaluation order (every NAF
    partial sum, every pre-shift tap accumulator).
  * :func:`range_certificate` — the largest input interval for which the
    whole forward+inverse cascade provably stays inside the engine's
    compute dtype, per (scheme, levels, mode, ndim, dtype).
  * :func:`certified_levels` — the deepest pyramid an input range
    supports; :func:`band_safe_input` — the headroom query behind
    fixed-width band packings.
  * :func:`run_checked` / :func:`run_checked_inv` — the checked
    execution mode behind every engine's ``checked=True`` and the
    ``REPRO_DWT_CHECKED`` toggle: level by level, reduce the actual
    approximation to its min/max on its device (one ``torch.aminmax``,
    one device-to-host copy of two integers), push that interval through
    one level's trace on the host in Python integers, and raise
    :class:`~repro_torch.resilience.errors.IntegerOverflowError` before
    the level is computed if any intermediate could leave the compute
    dtype.  The comparison is never made in a device dtype.

The certificate math is the reference's line for line, so every query
returns the reference's numbers, int64 certificates included (the
engines themselves refuse int64 input).  Dtypes may be given as numpy
dtypes, their names, or torch dtypes.  The reference's ``_is_abstract``
has no counterpart: PyTorch runs eagerly, so nothing is ever traced.

Direction-insensitivity: within one level the mixed bands (e.g. 2-D
LH/HL) are grouped by their high-pass axis count and traced through the
hull of each group, so callers never need to know which axis an engine
transformed first — and the certificate derivation uses the identical
grouping, which guarantees the runtime check never rejects an input the
certificate admits.
"""
from __future__ import annotations

import functools
import os
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.schemes import (
    LiftStep,
    _inverse_steps,
    _naf,
    _roles,
    get_scheme,
    resolved_steps,
)
from repro_torch.resilience.errors import IntegerOverflowError

__all__ = [
    "Interval",
    "RangeTrace",
    "RangeCertificate",
    "trace_forward",
    "trace_inverse",
    "cascade_extremes",
    "range_certificate",
    "certified_levels",
    "band_safe_input",
    "assert_interval_safe",
    "checked_enabled",
    "run_checked",
    "run_checked_inv",
    "assert_encodable",
]

# engine compute dtype per accepted input dtype: the oracle's
# ``promote_narrow`` and the kernels' ``_compute_dtype`` both promote
# narrow integers to int32 and pass int32/int64 through; wide unsigned
# dtypes are rejected by the engines themselves before any check runs.
_COMPUTE_DTYPE = {
    "int8": "int32",
    "int16": "int32",
    "uint8": "int32",
    "uint16": "int32",
    "int32": "int32",
    "int64": "int64",
}


def _dtype_name(dtype) -> str:
    """The numpy name of ``dtype`` (a torch dtype, a numpy dtype or a
    name): the key of ``_COMPUTE_DTYPE``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


class Interval(NamedTuple):
    """A closed integer interval ``[lo, hi]`` in exact Python ints."""

    lo: int
    hi: int

    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))


class _Extremes:
    """Running min/max over every intermediate the cascade materializes."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: int = 0, hi: int = 0):
        self.lo, self.hi = lo, hi

    def see(self, iv: Interval) -> None:
        if iv.lo < self.lo:
            self.lo = iv.lo
        if iv.hi > self.hi:
            self.hi = iv.hi


def _neg(iv: Interval) -> Interval:
    return Interval(-iv.hi, -iv.lo)


def _add(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo + b.lo, a.hi + b.hi)


def _sub(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo - b.hi, a.hi - b.lo)


def _wmul_iv(iv: Interval, w: int, track: _Extremes) -> Interval:
    """Interval image of ``schemes.wmul`` — same NAF terms, same
    accumulation order, every partial sum recorded (``7*x`` peaks at
    ``8*x`` before the subtract, and the hardware sees that value)."""
    if w == 0:
        return Interval(0, 0)
    acc = None
    for t in _naf(abs(w)):
        k = abs(t).bit_length() - 1
        term = Interval(iv.lo << k, iv.hi << k) if k else iv
        track.see(term)
        if acc is None:
            acc = term if t > 0 else _neg(term)
        else:
            acc = _add(acc, term) if t > 0 else _sub(acc, term)
        track.see(acc)
    return _neg(acc) if w < 0 else acc


def _apply_taps_iv(
    st: LiftStep, tgt: Interval, src: Interval, track: _Extremes
) -> Interval:
    """Interval image of ``schemes._apply_taps``: the boundary reflect
    policy only re-reads entries of the same stream, so every tap read
    draws from the src stream's interval regardless of position."""
    acc = None
    for _off, w in st.taps:
        term = _wmul_iv(src, w, track)
        acc = term if acc is None else _add(acc, term)
        track.see(acc)
    if st.round_add:
        acc = Interval(acc.lo + st.round_add, acc.hi + st.round_add)
        track.see(acc)
    if st.shift:
        acc = Interval(acc.lo >> st.shift, acc.hi >> st.shift)
    out = _add(tgt, acc) if st.sign > 0 else _sub(tgt, acc)
    track.see(out)
    return out


def _walk_iv(
    steps: Tuple[LiftStep, ...],
    even: Interval,
    odd: Interval,
    track: _Extremes,
) -> Tuple[Interval, Interval]:
    streams = {"even": even, "odd": odd}
    for st in steps:
        tgt, src = _roles(st)
        streams[tgt] = _apply_taps_iv(st, streams[tgt], streams[src], track)
    return streams["even"], streams["odd"]


def _fwd_level_iv(
    steps, x: Interval, track: _Extremes
) -> Tuple[Interval, Interval]:
    """One forward level: both polyphase streams start at the input
    interval; returns (approx, detail) stream intervals."""
    return _walk_iv(steps, x, x, track)


def _inv_level_iv(
    inv_steps, s: Interval, d: Interval, track: _Extremes
) -> Interval:
    even, odd = _walk_iv(inv_steps, s, d, track)
    return even.hull(odd)


class RangeTrace(NamedTuple):
    """Result of a cascade trace.

    ``approx``   — interval of the final all-lowpass band.
    ``details``  — per level (outermost first), a tuple of intervals for
                   the ``2**ndim - 1`` detail positions of that level,
                   ordered by the level's band code with the lowest-
                   high-pass-count positions first.
    ``lo``/``hi``— global extremes over EVERY intermediate value the
                   cascade materializes (pre-shift tap sums, NAF partial
                   products, stream updates) — the bit-width budget.
    """

    approx: Interval
    details: Tuple[Tuple[Interval, ...], ...]
    lo: int
    hi: int

    def band_hull(self) -> Interval:
        h = self.approx
        for level in self.details:
            for iv in level:
                h = h.hull(iv)
        return h


def _check_args(levels: int, ndim: int) -> None:
    if levels < 0:
        raise ValueError(f"levels must be >= 0, got {levels}")
    if ndim < 1:
        raise ValueError(f"ndim must be >= 1, got {ndim}")


def trace_forward(
    scheme,
    levels: int,
    interval: Interval,
    *,
    mode: str = "jpeg2000",
    ndim: int = 1,
) -> RangeTrace:
    """Exact interval trace of the forward Mallat cascade.

    Band position ``i`` of a level carries ``popcount(i)`` high-pass
    axes; position 0 is the level's approx input to the next level.
    """
    _check_args(levels, ndim)
    steps = resolved_steps(get_scheme(scheme), mode)
    iv = Interval(int(interval[0]), int(interval[1]))
    if iv.lo > iv.hi:
        raise ValueError(f"empty interval {iv}")
    track = _Extremes()
    track.see(iv)
    approx = iv
    details: List[Tuple[Interval, ...]] = []
    for _ in range(levels):
        bands = [approx]
        for _axis in range(ndim):
            nxt: List[Interval] = []
            for b in bands:
                s, d = _fwd_level_iv(steps, b, track)
                nxt.extend((s, d))
            bands = nxt
        approx = bands[0]
        details.append(tuple(bands[1:]))
    return RangeTrace(approx, tuple(details), track.lo, track.hi)


def _group_hulls(
    approx: Interval, detail_ivs: Sequence[Interval], ndim: int
) -> List[Interval]:
    """Per-level band intervals -> hulls grouped by high-pass axis count.

    Returns ``hulls[h]`` for ``h = 0 .. ndim``; the runtime checks and
    the certificate derivation share this grouping (see module
    docstring), which is what makes them mutually consistent.
    """
    hulls: List[Interval] = [approx] + [None] * ndim  # type: ignore[list-item]
    for i, iv in enumerate(detail_ivs, start=1):
        h = bin(i).count("1")
        hulls[h] = iv if hulls[h] is None else hulls[h].hull(iv)
    # levels too shallow to populate a group (never happens for the
    # positional layout, but keep the algebra total):
    for h in range(1, ndim + 1):
        if hulls[h] is None:
            hulls[h] = Interval(0, 0)
    return hulls


def trace_inverse(
    scheme,
    levels: int,
    approx: Interval,
    details: Sequence[Sequence[Interval]],
    *,
    mode: str = "jpeg2000",
    ndim: int = 1,
) -> RangeTrace:
    """Interval trace of the inverse cascade from band intervals.

    ``details[l][i]`` is the interval of detail position ``i+1`` of
    level ``l+1`` (same layout :func:`trace_forward` produces).  Mixed
    bands are traced through their high-pass-count group hull, so any
    within-group ordering of the caller's intervals yields the same
    (sound) result.
    """
    _check_args(levels, ndim)
    if len(details) != levels:
        raise ValueError(
            f"expected {levels} levels of detail intervals, got {len(details)}"
        )
    inv = _inverse_steps(resolved_steps(get_scheme(scheme), mode))
    track = _Extremes()
    cur = Interval(int(approx[0]), int(approx[1]))
    track.see(cur)
    for det in reversed(list(details)):
        det_ivs = [Interval(int(d[0]), int(d[1])) for d in det]
        if len(det_ivs) != (1 << ndim) - 1:
            raise ValueError(
                f"level needs {(1 << ndim) - 1} detail intervals, "
                f"got {len(det_ivs)}"
            )
        hulls = _group_hulls(cur, det_ivs, ndim)
        bands = [hulls[bin(i).count("1")] for i in range(1 << ndim)]
        for b in bands:
            track.see(b)
        for _axis in range(ndim):
            bands = [
                _inv_level_iv(inv, bands[i], bands[i + 1], track)
                for i in range(0, len(bands), 2)
            ]
        cur = bands[0]
    return RangeTrace(cur, (), track.lo, track.hi)


def cascade_extremes(
    scheme,
    levels: int,
    interval: Interval,
    *,
    mode: str = "jpeg2000",
    ndim: int = 1,
) -> Interval:
    """Extremes of the forward cascade — the round-trip bit-width budget.

    Forward-only is the exact criterion for round-trip safety: each
    inverse step recomputes the SAME pre-shift accumulator from the same
    stream values the forward step used, so the inverse of an untouched
    pyramid replays the forward intermediates value-for-value — if the
    forward cascade fits the compute dtype, so does its inverse.  Bands
    that were perturbed independently (quantized, decoded from a foreign
    bitstream) void that replay argument; :func:`trace_inverse` bounds
    those, and the checked inverse post-verifies via the reconstruction
    (:func:`run_checked_inv`).
    """
    ft = trace_forward(scheme, levels, interval, mode=mode, ndim=ndim)
    return Interval(ft.lo, ft.hi)


# ---------------------------------------------------------------------------
# Certificates.
# ---------------------------------------------------------------------------


class RangeCertificate(NamedTuple):
    """Safe input interval for (scheme, levels, mode, ndim, dtype).

    ``lo``/``hi``          — the certified input interval: every input
                             whose samples lie inside it round-trips
                             bit-exactly (no intermediate can leave the
                             engine's compute dtype).
    ``band_lo``/``band_hi``— bounds of every band value certified inputs
                             can produce (what the codec layer validates
                             against).
    ``peak_lo``/``peak_hi``— extreme intermediates at the certified
                             input bound (the hardware bit-width budget).
    ``growth_bits``        — band-magnitude growth over the input bound,
                             in bits (the paper-style headroom figure).
    """

    scheme: str
    levels: int
    mode: str
    ndim: int
    dtype: str
    lo: int
    hi: int
    band_lo: int
    band_hi: int
    peak_lo: int
    peak_hi: int
    growth_bits: int

    def contains(self, lo: int, hi: int) -> bool:
        return self.lo <= int(lo) and int(hi) <= self.hi


def _compute_bounds(dtype_name: str) -> Tuple[int, int]:
    compute = _COMPUTE_DTYPE.get(dtype_name)
    if compute is None:
        raise TypeError(
            f"no integer range certificate for dtype {dtype_name!r}; the "
            f"engines accept {sorted(_COMPUTE_DTYPE)}"
        )
    info = np.iinfo(np.dtype(compute))
    return int(info.min), int(info.max)


def _input_interval(dtype_name: str, mag: int) -> Interval:
    """Magnitude -> input interval: symmetric for signed dtypes,
    ``[0, mag]`` for the (narrow) unsigned ones."""
    if dtype_name.startswith("u"):
        return Interval(0, mag)
    return Interval(-mag, mag)


@functools.lru_cache(maxsize=None)
def _certificate(
    sch, levels: int, dtype_name: str, mode: str, ndim: int
) -> RangeCertificate:
    cmin, cmax = _compute_bounds(dtype_name)
    cap = int(np.iinfo(np.dtype(dtype_name)).max)

    def safe(mag: int) -> bool:
        ext = cascade_extremes(
            sch, levels, _input_interval(dtype_name, mag), mode=mode,
            ndim=ndim,
        )
        return cmin <= ext.lo and ext.hi <= cmax

    # interval propagation is inclusion-monotone, so the safe set of
    # magnitudes is a prefix of [0, cap] and binary search is exact
    if safe(cap):
        mag = cap
    else:
        lo_m, hi_m = 0, cap  # safe(lo_m) holds, safe(hi_m) fails
        while hi_m - lo_m > 1:
            mid = (lo_m + hi_m) // 2
            if safe(mid):
                lo_m = mid
            else:
                hi_m = mid
        mag = lo_m
    iv = _input_interval(dtype_name, mag)
    ft = trace_forward(sch, levels, iv, mode=mode, ndim=ndim)
    bands = ft.band_hull()
    in_bits = max(abs(iv.lo), abs(iv.hi)).bit_length()
    band_bits = max(abs(bands.lo), abs(bands.hi)).bit_length()
    return RangeCertificate(
        scheme=sch.name,
        levels=levels,
        mode=mode,
        ndim=ndim,
        dtype=dtype_name,
        lo=iv.lo,
        hi=iv.hi,
        band_lo=bands.lo,
        band_hi=bands.hi,
        peak_lo=ft.lo,
        peak_hi=ft.hi,
        growth_bits=max(0, band_bits - in_bits),
    )


def range_certificate(
    scheme,
    levels: int,
    dtype,
    *,
    mode: str = "jpeg2000",
    ndim: int = 1,
) -> RangeCertificate:
    """The widest safe input interval, derived from the step specs.

    Binary-searches the largest input magnitude whose forward AND
    inverse cascade extremes stay inside the engine's compute dtype for
    ``dtype`` inputs (narrow ints compute in int32).  Nothing here is
    per-scheme: a newly registered scheme gets its certificate from the
    same algebra that prices its adders.
    """
    _check_args(levels, ndim)
    sch = get_scheme(scheme)
    return _certificate(sch, int(levels), _dtype_name(dtype), mode, int(ndim))


def certified_levels(
    scheme,
    dtype,
    input_range: Tuple[int, int],
    *,
    mode: str = "jpeg2000",
    ndim: int = 1,
    max_levels: int = 32,
) -> int:
    """Deepest pyramid the given input range is certified for.

    The inverse query of :func:`range_certificate`: returns the largest
    ``L`` such that every sample in ``input_range`` survives an
    ``L``-level forward+inverse cascade without any intermediate leaving
    the compute dtype.  ``0`` means even one level could wrap.
    """
    _check_args(0, ndim)
    sch = get_scheme(scheme)
    lo, hi = int(input_range[0]), int(input_range[1])
    if lo > hi:
        raise ValueError(f"empty input range ({lo}, {hi})")
    cmin, cmax = _compute_bounds(_dtype_name(dtype))
    if lo < cmin or hi > cmax:
        return 0
    level = 0
    while level < max_levels:
        ext = cascade_extremes(
            sch, level + 1, Interval(lo, hi), mode=mode, ndim=ndim
        )
        if ext.lo < cmin or ext.hi > cmax:
            break
        level += 1
    return level


@functools.lru_cache(maxsize=None)
def _band_safe_input(sch, levels: int, band_limit: int, mode: str, ndim: int) -> int:
    cmin, cmax = _compute_bounds("int32")

    def safe(mag: int) -> bool:
        ft = trace_forward(sch, levels, Interval(-mag, mag), mode=mode, ndim=ndim)
        bands = ft.band_hull()
        return (
            -band_limit <= bands.lo
            and bands.hi <= band_limit
            and cmin <= ft.lo
            and ft.hi <= cmax
        )

    lo_m, hi_m = 0, band_limit + 1  # gain >= 1: mag > limit never fits
    while hi_m - lo_m > 1:
        mid = (lo_m + hi_m) // 2
        if safe(mid):
            lo_m = mid
        else:
            hi_m = mid
    return lo_m


def band_safe_input(
    scheme,
    levels: int,
    band_limit: int,
    *,
    mode: str = "jpeg2000",
    ndim: int = 1,
) -> int:
    """Largest input magnitude whose forward band values provably fit
    ``[-band_limit, band_limit]`` (and whose intermediates fit int32).

    The headroom-budgeting query behind fixed-width band packings: the
    checkpoint ``wz`` family packs bands into int16, and the right
    quantization limit is this derived bound rather than a per-scheme
    ``32767 >> k`` guess — a newly registered scheme gets the budget its
    own step specs imply.
    """
    _check_args(levels, ndim)
    if band_limit < 0:
        raise ValueError(f"band_limit must be >= 0, got {band_limit}")
    sch = get_scheme(scheme)
    return _band_safe_input(sch, int(levels), int(band_limit), mode, int(ndim))


def assert_interval_safe(
    lo: int,
    hi: int,
    *,
    scheme,
    levels: int,
    dtype,
    mode: str = "jpeg2000",
    ndim: int = 1,
    label: str = "dwt",
) -> None:
    """Boundary admission check: raise the typed overflow error when the
    full forward cascade of ``[lo, hi]`` samples could leave the compute
    dtype.  One full-cascade trace, no device work — the cheap check for
    admission edges (serve ``submit``) where the transform has not run
    yet; engines themselves use the tighter per-level walk."""
    cmin, cmax = _compute_bounds(_dtype_name(dtype))
    ext = cascade_extremes(
        scheme, levels, Interval(int(lo), int(hi)), mode=mode, ndim=ndim
    )
    if ext.lo < cmin or ext.hi > cmax:
        raise _overflow(
            label,
            f"samples in [{lo}, {hi}] can drive a "
            f"{get_scheme(scheme).name} ({ndim}-D, {mode}) x{levels}-level "
            f"lifting intermediate to [{ext.lo}, {ext.hi}], outside the "
            f"{_COMPUTE_DTYPE[_dtype_name(dtype)]} compute range",
        )


# ---------------------------------------------------------------------------
# Checked execution mode (the runtime face of the certificates).
# ---------------------------------------------------------------------------

_ENV = "REPRO_DWT_CHECKED"
_OFF = ("", "0", "false", "off", "no")


def checked_enabled(checked=None) -> bool:
    """Resolve the effective checked flag: an explicit kwarg wins, else
    the ``REPRO_DWT_CHECKED`` env toggle.  The disabled path is this one
    predicate — no tracing, no device work, no dispatch-key change."""
    if checked is not None:
        return bool(checked)
    return os.environ.get(_ENV, "").strip().lower() not in _OFF


def _int_leaves(tree) -> List[torch.Tensor]:
    """The integer tensors of a pyramid, band tuple or tensor, in
    field order (a pyramid's approximation first)."""
    if isinstance(tree, torch.Tensor):
        ok = not (tree.is_floating_point() or tree.is_complex() or tree.dtype == torch.bool)
        return [tree] if ok else []
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _int_leaves(sub)]
    return []


def _data_interval(arrays: Sequence[torch.Tensor]) -> Interval:
    """Min and max over the tensors, one reduction each on its device and
    one copy of the two results to the host, as Python ints.  uint16 has
    no device reduction in torch and is widened to int32 first."""
    lo = hi = None
    for a in arrays:
        if a.dtype == torch.uint16:
            a = a.to(torch.int32)
        mn, mx = torch.aminmax(a)
        pair = torch.stack((mn.to(torch.int64), mx.to(torch.int64))).tolist()
        lo = pair[0] if lo is None else min(lo, pair[0])
        hi = pair[1] if hi is None else max(hi, pair[1])
    return Interval(int(lo), int(hi))


def _overflow(label: str, detail: str) -> IntegerOverflowError:
    return IntegerOverflowError(
        f"{label}: {detail} — rerun within the certified interval "
        "(repro_torch.core.ranges.range_certificate), reduce levels "
        "(certified_levels), or pre-scale the samples"
    )


def _step_down(cur: torch.Tensor, *, scheme, mode: str, ndim: int) -> torch.Tensor:
    """The next level's approximation of ``cur``, through the port's own
    dispatch (``kernels.dwt_fwd_nd``: the 1-D, 2-D or volume kernels on
    the card) with ``checked=False``: re-entering checked mode here
    (``REPRO_DWT_CHECKED`` set) would re-check a level that was just
    certified."""
    from repro_torch.kernels import fused3d

    return fused3d.dwt_fwd_nd(cur, levels=1, mode=mode, scheme=scheme, ndim=ndim,
                              checked=False).approx


def _check_cascade(
    x: torch.Tensor,
    *,
    scheme,
    levels: int,
    mode: str,
    ndim: int,
    label: str,
    what: str = "samples",
) -> None:
    """Certify that the forward cascade on THIS tensor cannot wrap.

    Level by level: measure the current approximation's actual min/max
    on its device, push that interval through ONE level's trace (raising
    the typed overflow error if any intermediate could leave the compute
    dtype), then step the approximation down with the port's transform
    and repeat.  Because each level re-measures real data, interval
    pessimism never compounds across levels.  Soundness is inductive:
    the level-``l`` check bounds every intermediate of level ``l``
    (including the approx it hands level ``l+1``) before that level is
    ever computed.
    """
    dtype_name = _dtype_name(x.dtype)
    if dtype_name not in _COMPUTE_DTYPE:
        return  # engines own the rejection of unsupported dtypes
    if dtype_name == "int64":
        raise TypeError(
            "integer DWT computes in int32; int64 input is rejected — cast "
            "with .to(torch.int32) first"
        )
    cmin, cmax = _compute_bounds(dtype_name)
    cur = x
    for lvl in range(levels):
        data = _data_interval([cur])
        ft = trace_forward(scheme, 1, data, mode=mode, ndim=ndim)
        if ft.lo < cmin or ft.hi > cmax:
            raise _overflow(
                label,
                f"{what} in [{data.lo}, {data.hi}] at pyramid level "
                f"{lvl + 1}/{levels} can drive a {get_scheme(scheme).name} "
                f"({ndim}-D, {mode}) lifting intermediate to "
                f"[{ft.lo}, {ft.hi}], outside the "
                f"{_COMPUTE_DTYPE[dtype_name]} compute range",
            )
        if lvl + 1 < levels:
            cur = _step_down(cur, scheme=scheme, mode=mode, ndim=ndim)


def run_checked(
    fn,
    x: torch.Tensor,
    *,
    scheme,
    levels: int,
    mode: str = "jpeg2000",
    ndim: int = 1,
    label: str = "dwt",
):
    """Checked forward dispatch: certify the ACTUAL data level-by-level
    (:func:`_check_cascade`), then dispatch ``fn(x)``; raise the typed
    overflow error instead of ever returning wrapped bands.

    Sound for any input (the per-level interval image contains every
    reachable value) and exact on the certificate's interior: inputs
    inside ``range_certificate(...)`` never raise, by construction.  The
    price is one extra forward pass for the per-level stepping plus one
    device-to-host sync per level; the disabled path costs one predicate.
    """
    if x.numel():
        _check_cascade(x, scheme=scheme, levels=levels, mode=mode, ndim=ndim, label=label)
    return fn(x)


def run_checked_inv(
    fn,
    tree,
    *,
    scheme,
    levels: int,
    mode: str = "jpeg2000",
    ndim: int = 1,
    label: str = "dwt_inv",
):
    """Checked inverse dispatch: run the inverse, then certify the
    reconstruction before returning it.

    Soundness via the replay argument: the engine's inverse is exact in
    modulo arithmetic, so the returned ``x_hat`` always satisfies
    ``wrapped_forward(x_hat) == bands``.  If the per-level certification
    of ``x_hat``'s forward cascade (:func:`_check_cascade`) passes, the
    wrapped forward IS the true forward — so the bands were exactly the
    true coefficients of ``x_hat``, and every intermediate the inverse
    replayed stayed in range.  If it fails, the typed error is raised
    instead of returning a reconstruction that only modulo arithmetic
    believes in.  A legitimate pyramid (bands of any in-certificate
    input) is never rejected, because its reconstruction is that input.
    """
    leaves = _int_leaves(tree)
    if not leaves or _dtype_name(leaves[0].dtype) not in _COMPUTE_DTYPE:
        return fn(tree)
    out = fn(tree)
    out_leaves = _int_leaves(out)
    if not out_leaves or not out_leaves[0].numel():
        return out
    _check_cascade(
        out_leaves[0],
        scheme=scheme,
        levels=levels,
        mode=mode,
        ndim=ndim,
        label=label,
        what="reconstruction samples",
    )
    return out


def assert_encodable(
    bands,
    *,
    scheme,
    levels: int,
    ndim: int = 1,
    mode: str = "jpeg2000",
    label: str = "encode",
) -> None:
    """Boundary validation for the codec edge: every band value must lie
    inside the certificate's band envelope for int32 pyramids, so a
    bitstream we emit is always one the inverse transform can decode
    without wrapping.  Raises the typed overflow error; never clamps.
    Bands are tensors (reduced where they live) or arrays."""
    cert = range_certificate(scheme, levels, np.int32, mode=mode, ndim=ndim)
    for band in bands:
        if isinstance(band, torch.Tensor):
            if band.numel() == 0 or not _int_leaves(band):
                continue
            lo, hi = _data_interval([band])
        else:
            arr = np.asarray(band)
            if arr.size == 0 or not np.issubdtype(arr.dtype, np.integer):
                continue
            lo, hi = int(arr.min()), int(arr.max())
        if lo < cert.band_lo or hi > cert.band_hi:
            raise _overflow(
                label,
                f"band values in [{lo}, {hi}] exceed the certified "
                f"{cert.scheme} x{levels}-level band envelope "
                f"[{cert.band_lo}, {cert.band_hi}]",
            )
