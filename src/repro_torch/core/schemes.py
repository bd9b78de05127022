"""Lifting-scheme registry and the lifting primitives, on torch tensors.

Port of ``repro.core.schemes``.  A scheme is an ordered sequence of
:class:`LiftStep`, each a multiplierless shift-add update of one
polyphase stream from the other:

    predict:  odd[n]  += sign * ((sum_i w_i * even[n + o_i] + r) >> k)
    update:   even[n] += sign * ((sum_i w_i * odd[n + o_i]  + r) >> k)

Tap weights are applied as signed power-of-two sums (:func:`wmul`), so
no scheme lowers to a multiply; a step's inverse is the same read with
the sign flipped.  The derived structure (``fwd_margin``,
``inv_margin``, ``halo``, ``symmetric``, ``can_window``,
``pair_op_counts``) is computed exactly as the reference computes it.

Boundary policy: each stream entry stands for a sample position (even
entry p -> 2p, odd entry p -> 2p+1); an out-of-range read reflects the
POSITION whole-point about 0 and N-1 and reads that entry of the same
stream (:func:`reflect_entry`).

Integer semantics: int32 with two's-complement wraparound and an
arithmetic ``>>`` of negative values — what the reference's XLA ops do
and what torch's int32 ops do on both devices.  The CUDA kernels
(``csrc/lift2d.cuh``) repeat this arithmetic in ``uint32_t`` so that
wraparound is defined behaviour there too.

Four primitives carry every 2-D engine of the port:

  :func:`lift_fwd_axis` / :func:`lift_inv_axis`
      band-policy math along one axis of a full tensor — the oracle
      (``core.lifting``) and the whole-image kernel's plain version.
  :func:`lift_fwd_axis_ext` / :func:`lift_inv_axis_ext`
      interior-only math along one axis of an already-extended tensor —
      the tiled kernel's plain version (``kernels/tiled2d.py``).
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_MODES = ("paper", "jpeg2000")


def check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")


class LiftStep(NamedTuple):
    """One lifting step: target stream += sign * ((taps + round) >> shift).

    ``kind``   — "predict" (modifies the odd stream from the even) or
                 "update" (modifies the even stream from the odd).
    ``taps``   — ((offset, weight), ...) reads into the OTHER stream,
                 offsets relative to the target index n.
    ``shift``  — arithmetic right-shift amount (floor division by 2^k).
    ``sign``   — +1 or -1 applied to the shifted sum.
    ``round_add`` — constant added before the shift (rounding offset).
    """

    kind: str
    taps: Tuple[Tuple[int, int], ...]
    shift: int
    sign: int
    round_add: int = 0


class LiftingScheme(NamedTuple):
    """A named lifting scheme (see module docstring)."""

    name: str
    steps: Tuple[LiftStep, ...]
    doc: str = ""

    @property
    def fwd_margin(self) -> int:
        return _margins(self.steps)

    @property
    def inv_margin(self) -> int:
        return _margins(_inverse_steps(self.steps))

    @property
    def halo(self) -> int:
        """Reflect-halo width in SAMPLES per side for windowed forwards."""
        return 2 * self.fwd_margin

    @property
    def symmetric(self) -> bool:
        return _symmetric(self.steps)

    def can_window(self, n: int) -> bool:
        """True when a windowed (reflect-extended interior) execution
        along a length-``n`` axis reproduces the band-policy reference:
        the steps commute with whole-point reflection (any ``n >= 2``),
        or the scheme reads no out-of-range entry on this length (halo 0
        and even ``n``, e.g. haar)."""
        if n < 2:
            return False
        if self.symmetric:
            return True
        return self.halo == 0 and n % 2 == 0

    def pair_op_counts(self) -> Dict[str, int]:
        """Adders/shifters per output (s, d) pair — the Table-2 ledger."""
        adds = shifts = 0
        for st in self.steps:
            for _, w in st.taps:
                ta, ts = _wmul_ops(abs(w))
                adds, shifts = adds + ta, shifts + ts
            adds += len(st.taps) - 1  # summing the taps
            if st.round_add:
                adds += 1
            if st.shift:
                shifts += 1
            adds += 1  # fold into the target stream
        return {"adders": adds, "shifters": shifts, "multipliers": 0}


def _inverse_steps(steps: Tuple[LiftStep, ...]) -> Tuple[LiftStep, ...]:
    return tuple(st._replace(sign=-st.sign) for st in reversed(steps))


@functools.lru_cache(maxsize=None)
def _margins(steps: Tuple[LiftStep, ...]) -> int:
    """Smallest per-side pair margin whose interior cascade covers the core.

    Simulates valid-range shrinkage: with both streams valid on
    ``[-m, P+m)`` pairs, each step's target becomes valid only where all
    its reads are; the margin is minimal such that both cores ``[0, P)``
    stay valid after every step.
    """
    big = 1 << 20  # stands in for P: margins are tiny by comparison
    for m in range(0, 65):
        lo = {"even": -m, "odd": -m}
        hi = {"even": big + m, "odd": big + m}
        ok = True
        for st in steps:
            tgt, src = _roles(st)
            offs = [o for o, _ in st.taps]
            lo[tgt] = max(lo[tgt], lo[src] - min(offs))
            hi[tgt] = min(hi[tgt], hi[src] - max(offs))
            if lo[tgt] > 0 or hi[tgt] < big:
                ok = False
        if ok:
            return m
    raise ValueError("scheme support too wide (margin > 64 pairs)")


def _symmetric(steps: Tuple[LiftStep, ...]) -> bool:
    """True when every step's taps mirror around the target half-sample
    (predict: o <-> 1-o, update: o <-> -1-o, equal weights) — exactly
    the steps that commute with whole-point reflection of the input."""
    for st in steps:
        pivot = 1 if st.kind == "predict" else -1
        taps = dict(st.taps)
        if len(taps) != len(st.taps):
            return False
        for o, w in st.taps:
            if taps.get(pivot - o) != w:
                return False
    return True


def _roles(st: LiftStep) -> Tuple[str, str]:
    if st.kind == "predict":
        return "odd", "even"
    if st.kind == "update":
        return "even", "odd"
    raise ValueError(f"unknown step kind {st.kind!r}")


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, LiftingScheme] = {}


def _validate(scheme: LiftingScheme) -> LiftingScheme:
    for st in scheme.steps:
        _roles(st)  # validates kind
        if st.sign not in (-1, 1):
            raise ValueError(f"step sign must be +-1, got {st.sign}")
        if st.shift < 0 or not st.taps:
            raise ValueError(f"malformed step in scheme {scheme.name!r}")
    return scheme


def register_scheme(scheme: LiftingScheme) -> LiftingScheme:
    _REGISTRY[scheme.name] = _validate(scheme)
    return scheme


def scheme_from_spec(name: str, steps: Sequence[Sequence]) -> LiftingScheme:
    """A (validated, unregistered) scheme from plain step tuples
    ``(kind, taps, shift, sign[, round_add])`` — the form in which the
    reference's steps cross between packages."""
    return _validate(
        LiftingScheme(
            name=name,
            steps=tuple(
                LiftStep(
                    st[0],
                    tuple((int(o), int(w)) for o, w in st[1]),
                    *(int(v) for v in st[2:]),
                )
                for st in steps
            ),
        )
    )


def available_schemes() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_scheme(scheme) -> LiftingScheme:
    """Resolve a scheme name (or pass a LiftingScheme through)."""
    if isinstance(scheme, LiftingScheme):
        return scheme
    try:
        return _REGISTRY[scheme]
    except KeyError:
        raise ValueError(
            f"unknown lifting scheme {scheme!r}; registered: "
            f"{available_schemes()}"
        ) from None


def resolved_steps(scheme, mode: str) -> Tuple[LiftStep, ...]:
    """The scheme's steps with the mode's rounding rule applied.

    ``jpeg2000`` adds the round-to-nearest offset 2^(shift-1) to every
    UPDATE step (the ITU-T T.800 reversible convention; +2 for cdf53).
    ``paper`` keeps the declared offsets.
    """
    return _resolved_steps(get_scheme(scheme), mode)


@functools.lru_cache(maxsize=None)
def _resolved_steps(sch: LiftingScheme, mode: str) -> Tuple[LiftStep, ...]:
    check_mode(mode)
    steps = sch.steps
    if mode == "jpeg2000":
        steps = tuple(
            st._replace(round_add=st.round_add + (1 << (st.shift - 1)))
            if st.kind == "update" and st.shift > 0
            else st
            for st in steps
        )
    return steps


# The paper's (5,3): eq. (5) predict, eq. (7) update.
CDF53 = register_scheme(
    LiftingScheme(
        name="cdf53",
        steps=(
            LiftStep("predict", ((0, 1), (1, 1)), shift=1, sign=-1),
            LiftStep("update", ((-1, 1), (0, 1)), shift=2, sign=+1),
        ),
        doc="LeGall/CDF (5,3) — the paper's worked example (eqs. 5-10)",
    )
)

# Haar / S-transform: the shortest integer wavelet, support one pair.
HAAR = register_scheme(
    LiftingScheme(
        name="haar",
        steps=(
            LiftStep("predict", ((0, 1),), shift=0, sign=-1),
            LiftStep("update", ((0, 1),), shift=1, sign=+1),
        ),
        doc="Haar / S-transform: d = odd - even, s = even + (d >> 1)",
    )
)

# 2/6-style (S+P family): Haar followed by an antisymmetric gradient
# predict — the registry's non-`symmetric` scheme.
CDF22 = register_scheme(
    LiftingScheme(
        name="cdf22",
        steps=(
            LiftStep("predict", ((0, 1),), shift=0, sign=-1),
            LiftStep("update", ((0, 1),), shift=1, sign=+1),
            LiftStep("predict", ((1, 1), (-1, -1)), shift=2, sign=+1, round_add=2),
        ),
        doc="2/6 (S+P style): Haar + antisymmetric gradient lift on d",
    )
)

# Multiplierless integer approximation of the CDF 9/7 (dyadic weights
# alpha ~ -3/2, beta ~ -1/16, gamma ~ 7/8, delta ~ 7/16).
W97M = register_scheme(
    LiftingScheme(
        name="97m",
        steps=(
            LiftStep("predict", ((0, 3), (1, 3)), shift=1, sign=-1),
            LiftStep("update", ((-1, 1), (0, 1)), shift=4, sign=-1),
            LiftStep("predict", ((0, 7), (1, 7)), shift=3, sign=+1),
            LiftStep("update", ((-1, 7), (0, 7)), shift=4, sign=+1),
        ),
        doc="integer 9/7-M: dyadic shift-add approximation of CDF 9/7",
    )
)


# ---------------------------------------------------------------------------
# Multiplierless weight application (signed power-of-two decomposition).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _naf(w: int) -> Tuple[int, ...]:
    """Non-adjacent-form signed digits of ``w`` as +-2^k terms."""
    terms: List[int] = []
    k = 0
    while w:
        if w & 1:
            d = 2 - (w & 3)  # +1 if w % 4 == 1 else -1
            terms.append(d << k if d > 0 else -(1 << k))
            w -= d
        w >>= 1
        k += 1
    return tuple(terms)


def _wmul_ops(w: int) -> Tuple[int, int]:
    """(extra adds, extra shifts) to form w*x from x with shifts/adds."""
    terms = _naf(w)
    shifts = sum(1 for t in terms if abs(t) > 1)
    return len(terms) - 1, shifts


def wmul(x: Tensor, w: int) -> Tensor:
    """w * x as a sum of left shifts — never a multiply."""
    if w == 0:
        return torch.zeros_like(x)
    acc = None
    for t in _naf(abs(w)):
        k = abs(t).bit_length() - 1
        term = torch.bitwise_left_shift(x, k) if k else x
        if acc is None:
            acc = term if t > 0 else -term
        else:
            acc = acc + term if t > 0 else acc - term
    return -acc if w < 0 else acc


# ---------------------------------------------------------------------------
# Slicing and reflection helpers.
# ---------------------------------------------------------------------------


def _slc(x: Tensor, start: int, stop: int, axis: int, stride: int = 1) -> Tensor:
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop, stride)
    return x[tuple(idx)]


def split_axis(x: Tensor, axis: int) -> Tuple[Tensor, Tensor]:
    """Even/odd polyphase split along ``axis`` (the lazy wavelet)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    return _slc(x, 0, n, axis, stride=2), _slc(x, 1, n, axis, stride=2)


def merge_axis(even: Tensor, odd: Tensor, axis: int, n: int) -> Tensor:
    """Interleave the polyphase streams back into ``n`` samples."""
    axis = axis % even.ndim
    n_o = odd.shape[axis]
    core = torch.stack([_slc(even, 0, n_o, axis), odd], dim=axis + 1)
    core = core.reshape(even.shape[:axis] + (2 * n_o,) + even.shape[axis + 1 :])
    if n > 2 * n_o:  # odd length: the final lone even sample
        n_e = even.shape[axis]
        core = torch.cat([core, _slc(even, n_e - 1, n_e, axis)], dim=axis)
    return core


def reflect_indices(start: int, count: int, n: int) -> np.ndarray:
    """Whole-point reflected SAMPLE indices ``start .. start+count-1``
    (reflection about 0 and n-1, period ``2*(n-1)``)."""
    pos = np.arange(start, start + count)
    if n == 1:
        return np.zeros_like(pos)
    period = 2 * (n - 1)
    q = np.mod(pos, period)
    return np.where(q > n - 1, period - q, q)


def reflect_entries(start: int, count: int, parity: int, n: int) -> np.ndarray:
    """Whole-point reflected BAND-ENTRY indices (see :func:`reflect_entry`),
    vectorized: entry p of the parity-``parity`` stream of a length-``n``
    signal maps to the in-range entry of the same stream."""
    pos = reflect_indices(2 * start + parity, 2 * count, n)[::2]
    if np.any((pos - parity) % 2):
        raise AssertionError("whole-point reflection changed parity")
    return (pos - parity) // 2


def reflect_entry(p: int, parity: int, n: int) -> int:
    """Whole-point position reflection of stream entry ``p`` into range:
    entry ``p`` of the parity-``parity`` stream sits at sample
    ``2p + parity``; reflect that position about 0 and n-1 and return
    the entry (same stream) it lands on."""
    pos = 2 * p + parity
    if n == 1:
        return 0
    period = 2 * (n - 1)
    pos %= period
    if pos > n - 1:
        pos = period - pos
    if (pos - parity) % 2:
        raise AssertionError("whole-point reflection changed parity")
    return (pos - parity) // 2


def _policy_read(
    src: Tensor, parity: int, start: int, count: int, axis: int, n: int
) -> Tensor:
    """Entries ``src[start : start+count]`` under the reflect policy
    (out-of-range entries become single-entry slices of the reflected
    in-range entry)."""
    axis = axis % src.ndim
    src_len = src.shape[axis]
    parts: List[Tensor] = []
    p = start
    while p < min(0, start + count):
        q = reflect_entry(p, parity, n)
        parts.append(_slc(src, q, q + 1, axis))
        p += 1
    core_hi = min(start + count, src_len)
    if p < core_hi:
        parts.append(_slc(src, p, core_hi, axis))
        p = core_hi
    while p < start + count:
        q = reflect_entry(p, parity, n)
        parts.append(_slc(src, q, q + 1, axis))
        p += 1
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=axis)


def _apply_taps(
    st: LiftStep, tgt: Tensor, reads: List[Tensor], inverse: bool
) -> Tensor:
    """target +- ((sum of weighted reads + round) >> shift)."""
    acc = None
    for (_, w), col in zip(st.taps, reads):
        term = wmul(col, w)
        acc = term if acc is None else acc + term
    if st.round_add:
        acc = acc + st.round_add
    if st.shift:
        acc = torch.bitwise_right_shift(acc, st.shift)
    sign = -st.sign if inverse else st.sign
    return tgt + acc if sign > 0 else tgt - acc


# ---------------------------------------------------------------------------
# The two cascade walkers: forward (declared order) or inverse (reversed
# order, flipped signs).
# ---------------------------------------------------------------------------


def _walk_policy(
    even: Tensor, odd: Tensor, steps, axis: int, n: int, inverse: bool
) -> Tuple[Tensor, Tensor]:
    """Run the cascade over full streams with band-policy reads."""
    streams = {"even": even, "odd": odd}
    parity = {"even": 0, "odd": 1}
    for st in reversed(steps) if inverse else steps:
        tgt, src = _roles(st)
        t = streams[tgt]
        t_len = t.shape[axis]
        reads = [
            _policy_read(streams[src], parity[src], off, t_len, axis, n)
            for off, _ in st.taps
        ]
        streams[tgt] = _apply_taps(st, t, reads, inverse=inverse)
    return streams["even"], streams["odd"]


def _walk_ext(
    even: Tensor, odd: Tensor, steps, axis: int, margin: int, inverse: bool
) -> Tuple[Tensor, Tensor]:
    """Run the cascade as interior-only math on margin-extended streams.

    Tracks each stream's valid range [lo, hi) in extended-pair
    coordinates: a step's target becomes valid only where all its reads
    are, and the final cores are cropped to ``[margin, margin + core)``.
    """
    p_ext = even.shape[axis]
    core = p_ext - 2 * margin
    arrs = {"even": even, "odd": odd}
    lo = {"even": 0, "odd": 0}
    hi = {"even": p_ext, "odd": p_ext}
    start = {"even": 0, "odd": 0}
    for st in reversed(steps) if inverse else steps:
        tgt, src = _roles(st)
        offs = [o for o, _ in st.taps]
        new_lo = max(lo[tgt], lo[src] - min(offs))
        new_hi = min(hi[tgt], hi[src] - max(offs))
        reads = [
            _slc(arrs[src], new_lo + off - start[src], new_hi + off - start[src], axis)
            for off, _ in st.taps
        ]
        t = _slc(arrs[tgt], new_lo - start[tgt], new_hi - start[tgt], axis)
        arrs[tgt] = _apply_taps(st, t, reads, inverse=inverse)
        lo[tgt], hi[tgt], start[tgt] = new_lo, new_hi, new_lo
    return (
        _slc(arrs["even"], margin - start["even"], margin + core - start["even"], axis),
        _slc(arrs["odd"], margin - start["odd"], margin + core - start["odd"], axis),
    )


# ---------------------------------------------------------------------------
# Band-policy transforms (the reference semantics, any scheme, any N >= 2).
# ---------------------------------------------------------------------------


def lift_fwd_axis(
    x: Tensor, scheme, axis: int = -1, mode: str = "paper"
) -> Tuple[Tensor, Tensor]:
    """One forward level along ``axis`` under the band reflect policy."""
    sch = get_scheme(scheme)
    axis = axis % x.ndim
    n = x.shape[axis]
    if n < 2:
        raise ValueError(f"need at least 2 samples, got {n}")
    even, odd = split_axis(x, axis)
    return _walk_policy(even, odd, resolved_steps(sch, mode), axis, n, inverse=False)


def lift_inv_axis(
    s: Tensor, d: Tensor, scheme, axis: int = -1, mode: str = "paper"
) -> Tensor:
    """Structural inverse of :func:`lift_fwd_axis` (reversed steps)."""
    sch = get_scheme(scheme)
    axis = axis % s.ndim
    n_e, n_o = s.shape[axis], d.shape[axis]
    if n_e - n_o not in (0, 1):
        raise ValueError(f"band length mismatch: s={n_e}, d={n_o}")
    n = n_e + n_o
    even, odd = _walk_policy(s, d, resolved_steps(sch, mode), axis, n, inverse=True)
    return merge_axis(even, odd, axis, n)


# ---------------------------------------------------------------------------
# Interior transforms on extended tensors (the windowed/tiled engine).
# ---------------------------------------------------------------------------


def lift_fwd_axis_ext(
    x: Tensor, scheme, axis: int = -1, mode: str = "paper"
) -> Tuple[Tensor, Tensor]:
    """One forward level along ``axis`` of a halo-extended tensor.

    ``x`` carries ``scheme.halo`` extension samples at BOTH ends of the
    axis (even total length).  Returns the core ``(s, d)`` streams, each
    ``n_ext/2 - 2*fwd_margin`` entries.
    """
    sch = get_scheme(scheme)
    axis = axis % x.ndim
    even, odd = split_axis(x, axis)
    return _walk_ext(
        even, odd, resolved_steps(sch, mode), axis, sch.fwd_margin, inverse=False
    )


def lift_inv_axis_ext(
    s_ext: Tensor, d_ext: Tensor, scheme, axis: int = -1, mode: str = "paper"
) -> Tensor:
    """One inverse level along ``axis`` from margin-extended bands
    (``scheme.inv_margin`` entries at both ends).  Returns the merged
    core signal, ``2 * (len - 2*inv_margin)`` samples."""
    sch = get_scheme(scheme)
    axis = axis % s_ext.ndim
    m = sch.inv_margin
    even, odd = _walk_ext(s_ext, d_ext, resolved_steps(sch, mode), axis, m, inverse=True)
    return merge_axis(even, odd, axis, 2 * (s_ext.shape[axis] - 2 * m))
