"""Windowed 1-D lifting: the CUDA kernels and their plain versions.

Port of ``repro.kernels.dwt53`` (the module keeps its historical name;
the kernels take every registered scheme).  A windowed level over a
``(rows, n)`` int32 signal cuts each row into tiles; every tile carries
the scheme's reflect halo on both sides and runs the same interior-only
lifting math (``schemes.lift_fwd_axis_ext`` / ``lift_inv_axis_ext``), so
tiles are independent.  This reproduces the band-policy reference
exactly for schemes that commute with whole-point reflection on the
line's length (``scheme.can_window``).

On the card a **run** of consecutive levels is one launch each way
(``csrc/lift1d.cu``): a tile of T level-0 samples is read once, lifted
level after level in shared memory, and each level's d band written once
(:func:`lift_fwd_run` / :func:`lift_inv_run`; the plan, cached per shape,
scheme, mode and direction, splits a run only where no tile takes it,
:func:`run_launches`).  A run with a level its scheme cannot window
(cdf22; haar on an odd length) is a **policy run**: the same kernels
rewrite a line-end tile's out-of-range entries after every lifting step,
as the reference's band policy reads them, and size windows one pair
wider (:func:`run_policy`).  A CPU tensor runs the plain versions
:func:`lift_fwd_run_plain` / :func:`lift_inv_run_plain`: for a windowed
run the per-level loop of :func:`lift_fwd_windows_plain` /
:func:`lift_inv_windows_plain`, the windows gathered through the
reference's index maps (:func:`fwd_window_index`,
:func:`inv_window_index`) and the kernel bodies
:func:`fwd_windows_math` / :func:`inv_windows_math` run on them; for a
policy run the per-level loop of the band-policy oracle
(``schemes.lift_fwd_axis`` / ``lift_inv_axis``).
:func:`lift_fwd_windows` / :func:`lift_inv_windows` are one windowed
level at forced blocks: a run of one level on the card.  Lines under 8
pairs take the row pass (:func:`rows_fwd` / :func:`rows_inv`,
``csrc/whole2d.cu``), as the reference's ``_MIN_KERNEL_PAIRS`` fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import schemes as S
from repro_torch.kernels import _build
from repro_torch.kernels import backend as _backend

Tensor = torch.Tensor


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


# ---------------------------------------------------------------------------
# The kernel bodies on gathered windows (the reference's _fwd_kernel /
# _inv_kernel), and the window index maps of its ops._fwd_level /
# _inv_level.
# ---------------------------------------------------------------------------


def fwd_windows_math(wins: Tensor, mode: str, scheme="cdf53") -> Tuple[Tensor, Tensor]:
    """Forward cascade over ``(..., 2*bp + 2*halo)`` halo'd windows ->
    the core ``(s, d)`` pairs, ``(..., bp)`` each."""
    return S.lift_fwd_axis_ext(wins, scheme, axis=-1, mode=mode)


def inv_windows_math(s_wins: Tensor, d_wins: Tensor, mode: str, scheme="cdf53") -> Tensor:
    """Inverse cascade over ``(..., bp + 2*inv_margin)`` band windows ->
    ``(..., 2*bp)`` merged core samples."""
    return S.lift_inv_axis_ext(s_wins, d_wins, scheme, axis=-1, mode=mode)


def fwd_window_index(n: int, block_pairs: int, halo: int) -> np.ndarray:
    """(n_tiles, 2*bp + 2*halo) reflected sample indices: tile t covers
    core pairs [t*bp, (t+1)*bp), i.e. samples from 2*t*bp - halo."""
    n_tiles = _cdiv(n - n // 2, block_pairs)
    wlen = 2 * block_pairs + 2 * halo
    return np.stack([S.reflect_indices(2 * t * block_pairs - halo, wlen, n)
                     for t in range(n_tiles)])


def inv_window_index(n: int, block_pairs: int, margin: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_tiles, bp + 2*margin) reflected entry indices of the s and d
    bands of a length-n signal."""
    n_tiles = _cdiv(n - n // 2, block_pairs)
    wlen = block_pairs + 2 * margin
    idx = [np.stack([S.reflect_entries(t * block_pairs - margin, wlen, parity, n)
                     for t in range(n_tiles)]) for parity in (0, 1)]
    return idx[0], idx[1]


def _gather(a: Tensor, idx: np.ndarray) -> Tensor:
    return a[:, torch.as_tensor(idx, dtype=torch.long, device=a.device)]


def lift_fwd_windows_plain(x: Tensor, mode: str, block_pairs: int, scheme="cdf53"):
    """Plain version of the windowed forward level over a (rows, n) batch."""
    sch = S.get_scheme(scheme)
    rows, n = x.shape
    n_o = n // 2
    wins = _gather(x, fwd_window_index(n, block_pairs, sch.halo))
    s, d = fwd_windows_math(wins, mode, sch)
    return s.reshape(rows, -1)[:, : n - n_o], d.reshape(rows, -1)[:, :n_o]


def lift_inv_windows_plain(s: Tensor, d: Tensor, mode: str, block_pairs: int, scheme="cdf53"):
    """Plain version of the windowed inverse level over (rows, ...) bands."""
    sch = S.get_scheme(scheme)
    rows, n = s.shape[0], s.shape[1] + d.shape[1]
    idx_s, idx_d = inv_window_index(n, block_pairs, sch.inv_margin)
    x = inv_windows_math(_gather(s, idx_s), _gather(d, idx_d), mode, sch)
    return x.reshape(rows, -1)[:, :n]


# ---------------------------------------------------------------------------
# Kernels (csrc/lift1d.cu) and the row pass (csrc/whole2d.cu).
# ---------------------------------------------------------------------------


def _check_line(x: Tensor) -> None:
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] < 2:
        raise ValueError(f"need a (rows>=1, n>=2) batch, got {tuple(x.shape)}")


def band_len(s: Tensor, d: Tensor) -> int:
    """n of one level's (rows, n_e) / (rows, n_o) band pair; raises unless
    the shapes are the ones a forward level of a (rows, n) batch gives."""
    if (s.ndim != 2 or d.ndim != 2 or s.shape[0] != d.shape[0] or s.shape[0] < 1
            or s.shape[1] - d.shape[1] not in (0, 1) or d.shape[1] < 1):
        raise ValueError(f"band shape mismatch: s={tuple(s.shape)}, d={tuple(d.shape)}")
    return s.shape[1] + d.shape[1]


def _check_blocks(block_rows: int, block_pairs: int) -> None:
    if block_rows < 1 or block_pairs < 1:
        raise ValueError(f"block dims must be >= 1, got ({block_rows}, {block_pairs})")


def lift_fwd_windows_cuda(x: Tensor, mode: str, block_rows: int, block_pairs: int,
                          scheme="cdf53"):
    """One windowed forward level on a (rows, n) int32 CUDA batch through
    ``csrc/lift1d.cu``: a run of one level at tiles of ``2 * block_pairs``
    samples and ``block_rows`` rows a block.  Replaces
    ``repro.kernels.dwt53.lift_fwd_windows`` (``_fwd_kernel``)."""
    _check_blocks(block_rows, block_pairs)
    s, ds = lift_fwd_run_cuda(x, 1, mode, scheme, tile=2 * block_pairs, block_rows=block_rows)
    return s, ds[0]


def lift_inv_windows_cuda(s: Tensor, d: Tensor, mode: str, block_rows: int, block_pairs: int,
                          scheme="cdf53") -> Tensor:
    """One windowed inverse level on (rows, ...) int32 CUDA bands, a run
    of one level as :func:`lift_fwd_windows_cuda`.  Replaces
    ``repro.kernels.dwt53.lift_inv_windows`` (``_inv_kernel``)."""
    _check_blocks(block_rows, block_pairs)
    return lift_inv_run_cuda(s, [d], mode, scheme, tile=2 * block_pairs, block_rows=block_rows)


# ---------------------------------------------------------------------------
# Runs of levels (csrc/lift1d.cu): one launch each way.
# ---------------------------------------------------------------------------

MAX_RUN = 16  # levels one launch takes (lift1d.cu kMaxRun)


def run_lengths(n: int, levels: int) -> List[int]:
    """The input length of each level of a run from a line of n samples."""
    out = [n]
    for _ in range(levels - 1):
        out.append(out[-1] - out[-1] // 2)
    return out


def run_policy(sch: S.LiftingScheme, n: int, levels: int) -> bool:
    """Whether a run of ``levels`` levels from a length-n line is a policy
    run: some level's length is one the scheme cannot window."""
    return any(not sch.can_window(v) for v in run_lengths(n, levels))


def run_margins(sch: S.LiftingScheme, policy: bool) -> Tuple[int, int]:
    """The forward and inverse margins (pairs) a run's windows are sized
    from: the scheme's, one more for a policy run.  The band policy's
    rewrite of an out-of-range entry reads an in-range entry up to two
    entries before the line's end; where the last tile holds a single
    in-range entry at some level, that source lies a pair before the
    core, past the scheme's own margin."""
    return sch.fwd_margin + policy, sch.inv_margin + policy


def run_launches(rows: int, n: int, levels: int, scheme="cdf53",
                 device=None) -> Tuple[Tuple[int, int, int], ...]:
    """How a run of ``levels`` levels over ``rows`` lines of ``n``
    samples launches: ``(levels, tile, block_rows)`` per launch, finest
    first; from each level the longest run (up to :data:`MAX_RUN`) that
    a tile takes (``backend.run_tile``, at :func:`run_margins`), so one
    launch unless the line is too short or the run too deep for its
    reach."""
    sch = S.get_scheme(scheme)
    return _run_launches(rows, n, levels, sch, device)


@functools.lru_cache(maxsize=256)
def _run_launches(rows, n, levels, sch, device) -> Tuple[Tuple[int, int, int], ...]:
    out, k = [], 0
    lens = run_lengths(n, levels)
    fm, im = run_margins(sch, run_policy(sch, n, levels))
    while k < levels:
        for cnt in range(min(levels - k, MAX_RUN), 0, -1):
            pick = _backend.run_tile(rows, lens[k], cnt, fm, im, device)
            if pick is not None:
                break
        out.append((cnt,) + pick)
        k += cnt
    return tuple(out)


class _Launch(NamedTuple):
    """One launch of a run: levels [k0, k0 + levels), and the launcher's
    integer arguments (ctypes objects) that follow its pointers."""

    k0: int
    levels: int
    ints: Tuple[object, ...]


class _RunPlan(NamedTuple):
    """What one call of a run of a shape, scheme and direction needs
    besides its tensors, built once: the launches; each level's input
    length; forward: the views (shape, strides, offset) of the call's one
    allocation of ``total`` int32 entries, each on a 16-byte boundary —
    every level's d, then each launch's last s — and per launch the byte
    offsets of its band addresses (``offsets``); inverse: no views (each
    launch allocates its output).  ``table`` keeps the scheme table the
    ints point to alive."""

    launches: Tuple[_Launch, ...]
    lens: Tuple[int, ...]
    views: Tuple[Tuple[Tuple[int, int], Tuple[int, int], int], ...]
    total: int
    offsets: Tuple[np.ndarray, ...]
    table: np.ndarray


@functools.lru_cache(maxsize=256)
def _run_plan(rows, n, levels, sch, mode, inverse, device, tile=None, block_rows=None) -> _RunPlan:
    """The plan of a run of ``levels`` levels of a (rows, n) batch, a
    policy run where :func:`run_policy` says so; ``tile`` /
    ``block_rows`` force one launch at that geometry (the card tests,
    ``chip_smoke.py``) — one the card cannot take raises at the
    launch."""
    if tile is None:
        launches = _run_launches(rows, n, levels, sch, device)
    else:
        launches = ((levels, tile, block_rows),)
    lens = run_lengths(n, levels)
    table = _build.cascade_table(sch, mode, inverse)
    tail = (ctypes.c_void_p(table.ctypes.data), ctypes.c_int(len(table)))
    policy = run_policy(sch, n, levels)
    fm, im = run_margins(sch, policy)
    margin = im if inverse else fm
    runs, k0 = [], 0
    for cnt, t, rb in launches:
        runs.append(_Launch(k0, cnt, tuple(
            ctypes.c_int(v) for v in (rows, lens[k0], cnt, t, rb, margin, policy)) + tail))
        k0 += cnt
    if inverse:
        return _RunPlan(tuple(runs), tuple(lens), (), 0, (), table)
    # every level's d, then each launch's last s, on 16-byte boundaries
    last = [lens[ln.k0 + ln.levels - 1] for ln in runs]
    lengths = [v // 2 for v in lens] + [v - v // 2 for v in last]
    starts = np.cumsum([0] + [_cdiv(rows * v, 4) * 4 for v in lengths]).tolist()
    views = tuple(((rows, v), (v, 1), at) for v, at in zip(lengths, starts))
    offsets = tuple(np.asarray([4 * starts[k] for k in range(ln.k0, ln.k0 + ln.levels)]
                               + [4 * starts[levels + j]], np.int64)
                    for j, ln in enumerate(runs))
    return _RunPlan(tuple(runs), tuple(lens), views, starts[-1], offsets, table)


def _views(flat: Tensor, specs) -> List[Tensor]:
    return [flat.as_strided(*v) for v in specs]


def lift_fwd_run_cuda(x: Tensor, levels: int, mode: str, scheme="cdf53",
                      tile: Optional[int] = None, block_rows: Optional[int] = None):
    """Launch ``csrc/lift1d.cu``'s forward run on a (rows, n) int32 CUDA
    batch: ``levels`` levels, one launch per :func:`run_launches`
    entry (``tile`` / ``block_rows`` force one launch).  Returns the last
    level's s and each level's d, finest first, views of one allocation."""
    sch = S.get_scheme(scheme)
    _check_line(x)
    dev = _build.check_tensors("lift1d_fwd", [x])
    rows, n = x.shape
    plan = _run_plan(rows, n, levels, sch, mode, False, x.device, tile, block_rows)
    flat = x.new_empty((plan.total,))
    bands = _views(flat, plan.views)
    base, stream = flat.data_ptr(), _build.current_stream_handle(dev)
    src = x
    for j, (ln, offs) in enumerate(zip(plan.launches, plan.offsets)):
        ptrs = offs + base
        _build.call("lift1d", "repro_lift1d_run_fwd",
                    (dev, src.data_ptr(), ptrs.ctypes.data, *ln.ints, stream))
        _backend.launches.bump("lift1d_fwd")
        src = bands[levels + j]
    return src, bands[:levels]


def run_input_len(s: Tensor, ds: Sequence[Tensor]) -> int:
    """n of a run's level-0 input from its coarsest s and its d bands
    (finest first); raises unless each level's pair of band shapes is one
    a forward level of a (rows, n) batch gives."""
    n = s.shape[-1]
    for d in reversed(ds):
        if (s.ndim != 2 or d.ndim != 2 or d.shape[0] != s.shape[0] or s.shape[0] < 1
                or n - d.shape[1] not in (0, 1) or d.shape[1] < 1):
            raise ValueError(f"band shape mismatch: s={(s.shape[0], n)}, d={tuple(d.shape)}")
        n += d.shape[1]
    return n


def lift_inv_run_cuda(s: Tensor, ds: Sequence[Tensor], mode: str, scheme="cdf53",
                      tile: Optional[int] = None, block_rows: Optional[int] = None) -> Tensor:
    """Launch ``csrc/lift1d.cu``'s inverse run: the coarsest s and each
    level's d (finest first) of a run of levels -> the (rows, n)
    level-0 signal, one launch per :func:`run_launches` entry."""
    sch = S.get_scheme(scheme)
    dev = _build.check_tensors("lift1d_inv", [s, *ds])
    rows, n = s.shape[0], run_input_len(s, ds)
    plan = _run_plan(rows, n, len(ds), sch, mode, True, s.device, tile, block_rows)
    stream = _build.current_stream_handle(dev)
    src = s
    for ln in reversed(plan.launches):
        out = s.new_empty((rows, plan.lens[ln.k0]))
        ptrs = np.asarray([d.data_ptr() for d in ds[ln.k0:ln.k0 + ln.levels]]
                          + [src.data_ptr()], np.int64)
        _build.call("lift1d", "repro_lift1d_run_inv",
                    (dev, ptrs.ctypes.data, out.data_ptr(), *ln.ints, stream))
        _backend.launches.bump("lift1d_inv")
        src = out
    return src


def lift_fwd_run_plain(x: Tensor, levels: int, mode: str, scheme="cdf53"):
    """Plain version of a forward run: the per-level loop of
    :func:`lift_fwd_windows_plain` (one tile a row), or of the band-policy
    oracle for a policy run.  Returns the last level's s and each level's
    d, finest first."""
    sch = S.get_scheme(scheme)
    policy = run_policy(sch, x.shape[1], levels)
    ds = []
    for _ in range(levels):
        if policy:
            x, d = S.lift_fwd_axis(x, sch, axis=-1, mode=mode)
        else:
            x, d = lift_fwd_windows_plain(x, mode, x.shape[1] - x.shape[1] // 2, sch)
        ds.append(d)
    return x, ds


def lift_inv_run_plain(s: Tensor, ds: Sequence[Tensor], mode: str, scheme="cdf53") -> Tensor:
    """Plain version of an inverse run (``ds`` finest first): the
    per-level loop of :func:`lift_inv_windows_plain`, or of the
    band-policy oracle for a policy run."""
    sch = S.get_scheme(scheme)
    policy = run_policy(sch, run_input_len(s, ds), len(ds))
    for d in reversed(ds):
        if policy:
            s = S.lift_inv_axis(s, d, sch, axis=-1, mode=mode)
        else:
            s = lift_inv_windows_plain(s, d, mode, s.shape[1], sch)
    return s


def _check_windowable(sch: S.LiftingScheme, n: int) -> None:
    if not sch.can_window(n):
        raise ValueError(
            f"the windowed engine needs a length scheme {sch.name!r} can window, got {n}"
        )


def lift_fwd_windows(x: Tensor, mode: str, block_rows: int, block_pairs: int, scheme="cdf53"):
    """Windowed forward level over a (rows, n) int32 batch -> (s, d) with
    the reference band shapes: the kernel for a CUDA tensor,
    :func:`lift_fwd_windows_plain` for a CPU tensor."""
    sch = S.get_scheme(scheme)
    _check_line(x)
    _check_blocks(block_rows, block_pairs)
    if x.dtype != torch.int32:
        raise TypeError(f"need an int32 batch, got {x.dtype}")
    _check_windowable(sch, x.shape[1])
    if _backend.on_cuda(x):
        return lift_fwd_windows_cuda(x, mode, block_rows, block_pairs, sch)
    return lift_fwd_windows_plain(x, mode, block_pairs, sch)


def lift_inv_windows(s: Tensor, d: Tensor, mode: str, block_rows: int, block_pairs: int,
                     scheme="cdf53") -> Tensor:
    """Windowed inverse level over (rows, ...) int32 bands -> (rows, n):
    the kernel for CUDA tensors, :func:`lift_inv_windows_plain` for CPU
    ones."""
    sch = S.get_scheme(scheme)
    _check_blocks(block_rows, block_pairs)
    if s.dtype != torch.int32 or d.dtype != torch.int32:
        raise TypeError("need int32 bands")
    _check_windowable(sch, band_len(s, d))
    if _backend.on_cuda(s):
        return lift_inv_windows_cuda(s, d, mode, block_rows, block_pairs, sch)
    return lift_inv_windows_plain(s, d, mode, block_pairs, sch)


def _check_run(n: int, levels: int) -> None:
    if levels < 1:
        raise ValueError(f"a run has at least one level, got {levels}")
    if run_lengths(n, levels)[-1] < 2:
        raise ValueError(f"a line of {n} samples is too short for a run of {levels} levels")


def lift_fwd_run(x: Tensor, levels: int, mode: str, scheme="cdf53"):
    """A run of ``levels`` forward levels (windowed or policy) over a
    (rows, n) int32 batch -> (last s, [d of each level, finest first]):
    the kernel for a CUDA tensor, :func:`lift_fwd_run_plain` for a CPU
    tensor."""
    sch = S.get_scheme(scheme)
    _check_line(x)
    if x.dtype != torch.int32:
        raise TypeError(f"need an int32 batch, got {x.dtype}")
    _check_run(x.shape[1], levels)
    if _backend.on_cuda(x):
        return lift_fwd_run_cuda(x, levels, mode, sch)
    return lift_fwd_run_plain(x, levels, mode, sch)


def lift_inv_run(s: Tensor, ds: Sequence[Tensor], mode: str, scheme="cdf53") -> Tensor:
    """The inverse of a run (``ds`` finest first) -> (rows, n): the kernel
    for CUDA tensors, :func:`lift_inv_run_plain` for CPU ones."""
    sch = S.get_scheme(scheme)
    if s.dtype != torch.int32 or any(d.dtype != torch.int32 for d in ds):
        raise TypeError("need int32 bands")
    _check_run(run_input_len(s, ds), len(ds))
    if _backend.on_cuda(s):
        return lift_inv_run_cuda(s, ds, mode, sch)
    return lift_inv_run_plain(s, ds, mode, sch)


def rows_fwd_cuda(x: Tensor, mode: str, scheme="cdf53"):
    """Launch the row pass of ``csrc/whole2d.cu`` on a (rows, n) int32 CUDA
    batch: the 1-D level for lines under 8 pairs (the reference's
    in-graph ``lift_fwd_axis`` fallback, ``ops._fwd_level``)."""
    sch = S.get_scheme(scheme)
    _check_line(x)
    dev = _build.check_tensors("rows1d_fwd", [x])
    rows, n = x.shape
    s, d = x.new_empty((rows, n - n // 2)), x.new_empty((rows, n // 2))
    g = _backend.row_geometry(rows, n, x.device)
    scratch = x.new_empty((g["scratch"],)) if g["scratch"] else None
    _build.launch(
        "whole2d", "repro_rows_fwd", dev, (x, s, d, scratch),
        (rows, n, g["rb"], g["row_global"]), _build.cascade_table(sch, mode, inverse=False),
    )
    _backend.launches.bump("rows1d_fwd")
    return s, d


def rows_inv_cuda(s: Tensor, d: Tensor, mode: str, scheme="cdf53") -> Tensor:
    """Launch the inverse row pass of ``csrc/whole2d.cu`` on (rows, ...)
    int32 CUDA bands (the reference's ``lift_inv_axis`` fallback)."""
    sch = S.get_scheme(scheme)
    dev = _build.check_tensors("rows1d_inv", [s, d])
    n = band_len(s, d)
    rows = s.shape[0]
    x = s.new_empty((rows, n))
    g = _backend.row_geometry(rows, n, s.device)
    scratch = s.new_empty((g["scratch"],)) if g["scratch"] else None
    _build.launch(
        "whole2d", "repro_rows_inv", dev, (s, d, x, scratch),
        (rows, n, g["rb"], g["row_global"]), _build.cascade_table(sch, mode, inverse=True),
    )
    _backend.launches.bump("rows1d_inv")
    return x


def rows_fwd(x: Tensor, mode: str, scheme="cdf53"):
    """Row-pass forward level over a (rows, n) int32 batch: the kernel for
    a CUDA tensor, the band-policy math (``schemes.lift_fwd_axis``, the
    oracle) for a CPU tensor."""
    _check_line(x)
    if x.dtype != torch.int32:
        raise TypeError(f"need an int32 batch, got {x.dtype}")
    if _backend.on_cuda(x):
        return rows_fwd_cuda(x, mode, scheme)
    return S.lift_fwd_axis(x, scheme, axis=-1, mode=mode)


def rows_inv(s: Tensor, d: Tensor, mode: str, scheme="cdf53") -> Tensor:
    """Row-pass inverse level over (rows, ...) int32 bands."""
    if s.dtype != torch.int32 or d.dtype != torch.int32:
        raise TypeError("need int32 bands")
    band_len(s, d)
    if _backend.on_cuda(s):
        return rows_inv_cuda(s, d, mode, scheme)
    return S.lift_inv_axis(s, d, scheme, axis=-1, mode=mode)
