"""The 1-D integer lifting DWT: level dispatch, multi-level pyramids, checks.

Port of ``repro.kernels.ops``.  A transform runs where its input lives.
One level over a ``(rows, n)`` int32 stream takes one of two engines:

  * **run** (``kernels/dwt53.py``, ``csrc/lift1d.cu``) — halo'd tiles of
    every line, one pass over device memory; taken when the line has at
    least ``_MIN_KERNEL_PAIRS`` pairs, for every scheme.  Consecutive
    such levels of a pyramid form a run (:func:`level_runs_1d`) that is
    one launch each way: the level-0 signal read once, every band written
    once.  A run whose scheme windows on every level's length
    (``scheme.can_window``) reflects a tile's window once a level
    (``windowed``); any other (``cdf22``; ``haar`` on an odd length) is a
    policy run, whose line-end tiles reflect after every lifting step as
    the band policy does (``policy``).
  * **row pass** (``csrc/whole2d.cu``) — whole lines with band-policy
    reads at the borders, for lines under ``_MIN_KERNEL_PAIRS`` pairs.
    Where the reference falls back to in-graph band-policy math on such
    lines, the port runs this kernel on a CUDA tensor.

Each engine is a kernel for a CUDA tensor and its plain PyTorch version
for a CPU tensor.  Both give the oracle's bits (``core.lifting``), and
so ``repro``'s, for every scheme, both rounding modes and every n >= 2.

The public functions flatten leading dims, promote narrow dtypes to
int32 once (:func:`_compute_dtype`), validate lengths before any launch,
and take ``checked=`` (or ``REPRO_DWT_CHECKED``): certify the data
against the derived range bounds (``core/ranges.py``) and raise
``IntegerOverflowError`` instead of ever returning wrapped bands.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch.core import ranges as _ranges
from repro_torch.core import schemes as S
from repro_torch.core.lifting import WaveletPyramid
from repro_torch.kernels import backend as _backend
from repro_torch.kernels import dwt53 as _k

Tensor = torch.Tensor

_TO_INT32 = (torch.int8, torch.int16, torch.int32, torch.uint8, torch.uint16)

# below this many pairs a line takes the row pass, as in the reference
_MIN_KERNEL_PAIRS = 8


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the kernels compute in: int32, for every input dtype the
    oracle accepts (int8 / int16 / uint8 / uint16 promote, int32 passes).

    int64 is rejected, not computed: the reference runs JAX with x64
    disabled, so int64 input reaches its kernels already narrowed to
    int32, while torch would keep it int64 — the two would disagree past
    the int32 range.  The port makes the caller choose the cast
    (``core.lifting.promote_narrow`` applies the same rule)."""
    if dtype in _TO_INT32:
        return torch.int32
    if dtype == torch.int64:
        raise TypeError(
            "integer DWT computes in int32; int64 input is rejected — cast "
            "with .to(torch.int32) first"
        )
    raise TypeError(f"integer DWT requires an int dtype, got {dtype}")


def _rows(a: Tensor) -> Tensor:
    """(..., n) -> contiguous (rows, n) in the compute dtype.  The row
    count is the product of the lead dims, not ``-1``: that cannot be
    inferred when n is 0."""
    rows = math.prod(a.shape[:-1])
    return a.reshape(rows, a.shape[-1]).to(_compute_dtype(a.dtype)).contiguous()


# ---------------------------------------------------------------------------
# One level over (rows, n) int32 streams.
# ---------------------------------------------------------------------------


def _in_run(n: int) -> bool:
    """Whether a length-n level runs on the run kernels (any scheme)."""
    return n // 2 >= _MIN_KERNEL_PAIRS


def _fwd_level(xf: Tensor, sch: S.LiftingScheme, mode: str) -> Tuple[Tensor, Tensor]:
    """One forward level over a (rows, n) int32 stream; returns (s, d)."""
    rows, n = xf.shape
    if rows == 0:
        return xf[:, : n - n // 2], xf[:, : n // 2]
    if not _in_run(n):
        return _k.rows_fwd(xf, mode, sch)
    s, ds = _k.lift_fwd_run(xf, 1, mode, sch)
    return s, ds[0]


def _inv_level(sf: Tensor, df: Tensor, sch: S.LiftingScheme, mode: str) -> Tensor:
    """One inverse level over (rows, n_e) / (rows, n_o) int32 bands."""
    rows, n_e = sf.shape
    n = n_e + df.shape[-1]
    if rows == 0:
        return sf.new_empty((0, n))
    if not _in_run(n):
        return _k.rows_inv(sf, df, mode, sch)
    return _k.lift_inv_run(sf, [df], mode, sch)


def level_runs_1d(n: int, levels: int, sch) -> List[Tuple[bool, int]]:
    """The levels of a pyramid from a length-n line grouped as they
    launch, finest first: ``(True, c)`` for each maximal run of c
    consecutive levels of at least ``_MIN_KERNEL_PAIRS`` pairs
    (:func:`_in_run` on each level's own length, whatever the scheme),
    one call of ``dwt53.lift_fwd_run`` / ``lift_inv_run``; ``(False, 1)``
    for every other level (the row pass).  The 1-D counterpart of
    ``fused2d.level_runs``."""
    S.get_scheme(sch)
    runs: List[Tuple[bool, int]] = []
    for _ in range(levels):
        in_run = _in_run(n)
        if in_run and runs and runs[-1][0]:
            runs[-1] = (True, runs[-1][1] + 1)
        else:
            runs.append((in_run, 1))
        n -= n // 2
    return runs


def plan_1d(n: int, device="cuda", scheme="cdf53") -> str:
    """Name the path a length-n level takes on ``device``:
    ``windowed-*`` (a run level the scheme windows on this length),
    ``policy-*`` (a run level it does not: cdf22, haar on odd n) or
    ``rows-*`` (under 8 pairs); ``-cuda`` on the card, ``-torch`` for the
    plain versions a CPU tensor runs."""
    if not _in_run(n):
        kind = "rows"
    else:
        kind = "windowed" if S.get_scheme(scheme).can_window(n) else "policy"
    return f"{kind}-{'cuda' if _backend.resolve_device(device).type == 'cuda' else 'torch'}"


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


def _check_lead(a: Tensor, b: Tensor) -> None:
    if tuple(a.shape[:-1]) != tuple(b.shape[:-1]):
        raise ValueError(
            f"band lead dims differ: {tuple(a.shape[:-1])} vs {tuple(b.shape[:-1])}"
        )


def dwt_fwd_1d(
    x: Tensor, mode: str = "paper", scheme="cdf53", checked=None
) -> Tuple[Tensor, Tensor]:
    """One forward level along the last axis, on the device ``x`` lives
    on.  N >= 2; returns (s, d) with len(s) = ceil(N/2), len(d) =
    floor(N/2), bit-exact vs ``core.lifting.dwt_fwd_1d``.

    ``checked=True`` (or ``REPRO_DWT_CHECKED=1``) certifies the data
    against the derived range bounds first and raises
    :class:`~repro_torch.resilience.errors.IntegerOverflowError` instead
    of ever returning wrapped bands (``core/ranges.py``) — the same
    contract on every public transform of this package.
    """
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if x.ndim < 1 or x.shape[-1] < 2:
        raise ValueError("need at least 2 samples")
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked(
            lambda a: dwt_fwd_1d(a, mode=mode, scheme=sch, checked=False),
            x, scheme=sch, levels=1, mode=mode, ndim=1, label="kernels.dwt_fwd_1d",
        )
    lead = tuple(x.shape[:-1])
    s, d = _fwd_level(_rows(x), sch, mode)
    return s.reshape(lead + (s.shape[-1],)), d.reshape(lead + (d.shape[-1],))


def dwt_inv_1d(
    s: Tensor, d: Tensor, mode: str = "paper", scheme="cdf53", checked=None
) -> Tensor:
    """One inverse level along the last axis; bit-exact vs
    ``core.lifting.dwt_inv_1d``."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if s.shape[-1] - d.shape[-1] not in (0, 1):
        raise ValueError("band length mismatch")
    _check_lead(s, d)
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked_inv(
            lambda t: dwt_inv_1d(t[0], t[1], mode=mode, scheme=sch, checked=False),
            (s, d), scheme=sch, levels=1, mode=mode, ndim=1, label="kernels.dwt_inv_1d",
        )
    x = _inv_level(_rows(s), _rows(d), sch, mode)
    return x.reshape(tuple(s.shape[:-1]) + (x.shape[-1],))


def dwt_fwd(
    x: Tensor, levels: int = 1, mode: str = "paper", scheme="cdf53", checked=None
) -> WaveletPyramid:
    """Multi-level forward transform along the last axis: the streams stay
    on the device between levels, flattened and promoted once.

    ``levels=0`` is the identity pyramid, so ``levels=max_levels(n)``
    loops are safe on degenerate shapes.
    """
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if levels < 0:
        raise ValueError("levels must be >= 0")
    n = x.shape[-1]
    for _ in range(levels):
        if n < 2:
            raise ValueError(f"signal too short for {levels} levels (got {x.shape[-1]})")
        n = n - n // 2
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked(
            lambda a: dwt_fwd(a, levels=levels, mode=mode, scheme=sch, checked=False),
            x, scheme=sch, levels=levels, mode=mode, ndim=1, label="kernels.dwt_fwd",
        )
    lead = tuple(x.shape[:-1])
    s = _rows(x)
    details: List[Tensor] = []
    for windowed, count in level_runs_1d(s.shape[-1], levels, sch):
        if windowed and s.shape[0]:
            s, ds = _k.lift_fwd_run(s, count, mode, sch)
            details.extend(ds)
            continue
        for _ in range(count):  # the row pass, or no rows at all
            s, d = _fwd_level(s, sch, mode)
            details.append(d)
    return WaveletPyramid(
        approx=s.reshape(lead + (s.shape[-1],)),
        details=tuple(d.reshape(lead + (d.shape[-1],)) for d in reversed(details)),
    )


def dwt_inv(pyr: WaveletPyramid, mode: str = "paper", scheme="cdf53", checked=None) -> Tensor:
    """Multi-level inverse transform; band lengths are validated per level
    before any launch, so a malformed pyramid raises the reference's
    ``ValueError`` on every device."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked_inv(
            lambda p: dwt_inv(p, mode=mode, scheme=sch, checked=False),
            pyr, scheme=sch, levels=pyr.levels, mode=mode, ndim=1, label="kernels.dwt_inv",
        )
    n = pyr.approx.shape[-1]
    for d in pyr.details:  # coarsest first
        if n - d.shape[-1] not in (0, 1):
            raise ValueError(f"band length mismatch: s={n}, d={d.shape[-1]}")
        _check_lead(pyr.approx, d)
        n = n + d.shape[-1]
    lead = tuple(pyr.approx.shape[:-1])
    s = _rows(pyr.approx)
    fine = [_rows(d) for d in reversed(pyr.details)]  # finest first
    k = len(fine)
    for windowed, count in reversed(level_runs_1d(n, len(fine), sch)):
        k -= count
        if windowed and s.shape[0]:
            s = _k.lift_inv_run(s, fine[k:k + count], mode, sch)
            continue
        for j in range(k + count - 1, k - 1, -1):  # the row pass, or no rows at all
            s = _inv_level(s, fine[j], sch, mode)
    return s.reshape(lead + (s.shape[-1],))


# ---------------------------------------------------------------------------
# (5,3) aliases — the seed's public names.
# ---------------------------------------------------------------------------


def dwt53_fwd_1d(x: Tensor, mode: str = "paper", checked=None) -> Tuple[Tensor, Tensor]:
    return dwt_fwd_1d(x, mode=mode, scheme="cdf53", checked=checked)


def dwt53_inv_1d(s: Tensor, d: Tensor, mode: str = "paper", checked=None) -> Tensor:
    return dwt_inv_1d(s, d, mode=mode, scheme="cdf53", checked=checked)


def dwt53_fwd(x: Tensor, levels: int = 1, mode: str = "paper", checked=None) -> WaveletPyramid:
    return dwt_fwd(x, levels=levels, mode=mode, scheme="cdf53", checked=checked)


def dwt53_inv(pyr: WaveletPyramid, mode: str = "paper", checked=None) -> Tensor:
    return dwt_inv(pyr, mode=mode, scheme="cdf53", checked=checked)
