"""Windowed 1-D lifting level: the CUDA kernels and their plain versions.

Port of ``repro.kernels.dwt53`` (the module keeps its historical name;
the kernels take every registered scheme).  A level over a ``(rows, n)``
int32 signal cuts each row into tiles of ``block_pairs`` core pairs;
every tile carries the scheme's reflect halo on both sides and runs the
same interior-only lifting math (``schemes.lift_fwd_axis_ext`` /
``lift_inv_axis_ext``), so tiles are independent:

  forward : window (2*block_pairs + 2*halo samples) -> (s, d) core pairs
  inverse : band windows (block_pairs + 2*inv_margin entries each)
            -> 2*block_pairs core samples

This reproduces the band-policy reference exactly for schemes that
commute with whole-point reflection on the line's length
(``scheme.can_window``); the level dispatcher (``kernels/ops.py``)
routes only those here, and everything else to the row pass
(:func:`rows_fwd` / :func:`rows_inv`, ``csrc/whole2d.cu``).

:func:`lift_fwd_windows` / :func:`lift_inv_windows` are the wrappers: a
CUDA tensor launches ``csrc/lift1d.cu`` (one block per row group and
tile, the reflect gather done in the kernel), a CPU tensor runs the
plain version — the windows gathered through the reference's index maps
(:func:`fwd_window_index`, :func:`inv_window_index`) and the kernel
bodies :func:`fwd_windows_math` / :func:`inv_windows_math` run on them.
"""
from __future__ import annotations

from typing import Tuple

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
    """Launch ``csrc/lift1d.cu`` forward on a (rows, n) int32 CUDA batch.
    Replaces ``repro.kernels.dwt53.lift_fwd_windows`` (``_fwd_kernel``)."""
    sch = S.get_scheme(scheme)
    _check_line(x)
    _check_blocks(block_rows, block_pairs)
    dev = _build.check_tensors("lift1d_fwd", [x])
    rows, n = x.shape
    s, d = x.new_empty((rows, n - n // 2)), x.new_empty((rows, n // 2))
    _build.launch(
        "lift1d", "repro_lift1d_fwd", dev, (x, s, d),
        (rows, n, block_rows, block_pairs, sch.fwd_margin),
        _build.cascade_table(sch, mode, inverse=False),
    )
    _backend.launches.bump("lift1d_fwd")
    return s, d


def lift_inv_windows_cuda(s: Tensor, d: Tensor, mode: str, block_rows: int, block_pairs: int,
                          scheme="cdf53") -> Tensor:
    """Launch ``csrc/lift1d.cu`` inverse on (rows, ...) int32 CUDA bands.
    Replaces ``repro.kernels.dwt53.lift_inv_windows`` (``_inv_kernel``)."""
    sch = S.get_scheme(scheme)
    _check_blocks(block_rows, block_pairs)
    dev = _build.check_tensors("lift1d_inv", [s, d])
    n = band_len(s, d)
    x = s.new_empty((s.shape[0], n))
    _build.launch(
        "lift1d", "repro_lift1d_inv", dev, (s, d, x),
        (s.shape[0], n, block_rows, block_pairs, sch.inv_margin),
        _build.cascade_table(sch, mode, inverse=True),
    )
    _backend.launches.bump("lift1d_inv")
    return x


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


def rows_fwd_cuda(x: Tensor, mode: str, scheme="cdf53"):
    """Launch the row pass of ``csrc/whole2d.cu`` on a (rows, n) int32 CUDA
    batch: the 1-D level for what the windowed kernel does not take (the
    reference's in-graph ``lift_fwd_axis`` fallback, ``ops._fwd_level``)."""
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
