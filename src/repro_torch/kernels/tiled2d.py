"""Halo-tiled 2-D lifting level: the CUDA kernels and their plain versions.

Port of ``repro.kernels.tiled2d``.  The image is blocked into ``(TH, TW)``
core tiles, each extended by the scheme's halo on every side; every tile
runs the same interior-only lifting math (``schemes.lift_*_axis_ext``),
with the boundary policy carried entirely by whole-point reflection of
the window positions:

  forward : window (TH + 2*halo, TW + 2*halo) -> LL/LH/HL/HH (TH/2, TW/2)
  inverse : band windows (TH/2 + 2*m, TW/2 + 2*m), m = scheme.inv_margin
            -> image tile (TH, TW)

This reproduces the band-policy reference exactly for schemes that
commute with whole-point reflection (``scheme.can_window``); the level
dispatcher (``kernels/fused2d.py``) routes only those here.

:func:`fwd2d_tiled` / :func:`inv2d_tiled` are the wrappers: a CUDA tensor
launches ``csrc/tiled2d.cu`` (one block per tile, the reflect gather done
in the kernel), a CPU tensor runs :func:`fwd2d_tiled_plain` /
:func:`inv2d_tiled_plain`, which gather the windows through the same
reflected index maps and run :func:`fwd_window_math` /
:func:`inv_window_math` on them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import schemes as S
from repro_torch.kernels import _build
from repro_torch.kernels import backend as _backend

Tensor = torch.Tensor


def fwd_window_math(
    w: Tensor, mode: str, scheme="cdf53"
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Full 2-D level on a halo'd (..., TH+2h, TW+2h) window: rows, cols."""
    s_r, d_r = S.lift_fwd_axis_ext(w, scheme, axis=-1, mode=mode)
    ll, lh = S.lift_fwd_axis_ext(s_r, scheme, axis=-2, mode=mode)
    hl, hh = S.lift_fwd_axis_ext(d_r, scheme, axis=-2, mode=mode)
    return ll, lh, hl, hh


def inv_window_math(
    llw: Tensor, lhw: Tensor, hlw: Tensor, hhw: Tensor, mode: str, scheme="cdf53"
) -> Tensor:
    """Inverse 2-D level on margin-extended (..., P+2m, Q+2m) band windows."""
    s_col = S.lift_inv_axis_ext(llw, lhw, scheme, axis=-2, mode=mode)
    d_col = S.lift_inv_axis_ext(hlw, hhw, scheme, axis=-2, mode=mode)
    return S.lift_inv_axis_ext(s_col, d_col, scheme, axis=-1, mode=mode)


# ---------------------------------------------------------------------------
# Plain versions: reflected index maps, torch gather, window math.
# ---------------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def _win_rows(n_tiles: int, core: int, ext: int, idx_fn) -> np.ndarray:
    """(n_tiles, core + 2*ext) index rows for stride-``core`` windows."""
    return np.stack([idx_fn(t * core - ext, core + 2 * ext) for t in range(n_tiles)])


def _gather2d(x: Tensor, rows: np.ndarray, cols: np.ndarray) -> Tensor:
    """(B, H', W') -> (B, n_th, n_tw, wh, ww) overlapping windows."""
    r = torch.as_tensor(rows, dtype=torch.long, device=x.device)
    c = torch.as_tensor(cols, dtype=torch.long, device=x.device)
    win = x[:, r][:, :, :, c]  # (B, n_th, wh, n_tw, ww)
    return win.permute(0, 1, 3, 2, 4)


def _untile(t: Tensor) -> Tensor:
    """(B, n_th, n_tw, bh, bw) tiles -> (B, n_th*bh, n_tw*bw)."""
    b, n_th, n_tw, bh, bw = t.shape
    return t.permute(0, 1, 3, 2, 4).reshape(b, n_th * bh, n_tw * bw)


def fwd2d_tiled_plain(x: Tensor, mode: str, th: int, tw: int, scheme="cdf53"):
    """Plain version of the tiled forward level over a (B, H, W) batch."""
    sch = S.get_scheme(scheme)
    halo = sch.halo
    _, h, w = x.shape
    h_e, w_e, h_o, w_o = h - h // 2, w - w // 2, h // 2, w // 2
    n_th, n_tw = _cdiv(h_e, th // 2), _cdiv(w_e, tw // 2)
    rows = _win_rows(n_th, th, halo, lambda s, c: S.reflect_indices(s, c, h))
    cols = _win_rows(n_tw, tw, halo, lambda s, c: S.reflect_indices(s, c, w))
    ll, lh, hl, hh = (
        _untile(b) for b in fwd_window_math(_gather2d(x, rows, cols), mode, sch)
    )
    return ll[:, :h_e, :w_e], lh[:, :h_o, :w_e], hl[:, :h_e, :w_o], hh[:, :h_o, :w_o]


def inv2d_tiled_plain(
    ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor, mode: str, th: int, tw: int,
    scheme="cdf53",
) -> Tensor:
    """Plain version of the tiled inverse level over (B, ...) band batches."""
    sch = S.get_scheme(scheme)
    m = sch.inv_margin
    h, w = ll.shape[-2] + lh.shape[-2], ll.shape[-1] + hl.shape[-1]
    h_e, w_e = ll.shape[-2], ll.shape[-1]
    me, mo = th // 2, tw // 2
    n_th, n_tw = _cdiv(h_e, me), _cdiv(w_e, mo)
    # band-entry window maps per (axis, polyphase role): rows of ll/hl are
    # even-role over H, rows of lh/hh odd-role; columns of ll/lh are
    # even-role over W, columns of hl/hh odd-role
    r_s = _win_rows(n_th, me, m, lambda s, c: S.reflect_entries(s, c, 0, h))
    r_d = _win_rows(n_th, me, m, lambda s, c: S.reflect_entries(s, c, 1, h))
    c_s = _win_rows(n_tw, mo, m, lambda s, c: S.reflect_entries(s, c, 0, w))
    c_d = _win_rows(n_tw, mo, m, lambda s, c: S.reflect_entries(s, c, 1, w))
    x = inv_window_math(
        _gather2d(ll, r_s, c_s), _gather2d(lh, r_d, c_s),
        _gather2d(hl, r_s, c_d), _gather2d(hh, r_d, c_d), mode, sch,
    )
    return _untile(x)[:, :h, :w]


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensor -> kernel, CPU tensor -> plain version.
# ---------------------------------------------------------------------------


def band_dims(ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor) -> Tuple[int, int, int]:
    """(B, H, W) of one level's (B, ...) band batch; raises unless the
    four shapes are the ones a (B, H, W) forward level produces."""
    b, h_e, w_e = ll.shape
    h_o, w_o = lh.shape[1], hl.shape[2]
    want = [(b, h_e, w_e), (b, h_o, w_e), (b, h_e, w_o), (b, h_o, w_o)]
    got = [tuple(a.shape) for a in (ll, lh, hl, hh)]
    if got != want or h_e - h_o not in (0, 1) or w_e - w_o not in (0, 1) or not h_o or not w_o:
        raise ValueError(f"band shape mismatch: ll/lh/hl/hh = {got}")
    return b, h_e + h_o, w_e + w_o


def _check_tile(th: int, tw: int) -> None:
    if th < 4 or tw < 4 or th % 2 or tw % 2:
        raise ValueError(f"tile dims must be even and >= 4, got ({th}, {tw})")


def check_level_input(x: Tensor) -> None:
    """A forward level takes a (B, H >= 2, W >= 2) batch."""
    if x.ndim != 3 or x.shape[1] < 2 or x.shape[2] < 2:
        raise ValueError(f"need a (B, H>=2, W>=2) batch, got {tuple(x.shape)}")


def _check_windowable(sch: S.LiftingScheme, h: int, w: int) -> None:
    if not (sch.can_window(h) and sch.can_window(w)):
        raise ValueError(
            f"the tiled engine needs a shape scheme {sch.name!r} can window "
            f"along both axes, got ({h}, {w})"
        )


def fwd2d_tiled_cuda(x: Tensor, mode: str, th: int, tw: int, scheme="cdf53"):
    """Launch ``csrc/tiled2d.cu`` forward on a (B, H, W) int32 CUDA batch.
    Replaces ``repro.kernels.tiled2d.fwd2d_tiled`` (``_fwd_tile_kernel``)."""
    sch = S.get_scheme(scheme)
    _check_tile(th, tw)
    check_level_input(x)
    dev = _build.check_tensors("fwd2d_tiled", [x])
    bsz, h, w = x.shape
    h_e, w_e, h_o, w_o = h - h // 2, w - w // 2, h // 2, w // 2
    ll = x.new_empty((bsz, h_e, w_e))
    lh = x.new_empty((bsz, h_o, w_e))
    hl = x.new_empty((bsz, h_e, w_o))
    hh = x.new_empty((bsz, h_o, w_o))
    _build.launch(
        "tiled2d", "repro_tiled_fwd", dev, (x, ll, lh, hl, hh),
        (bsz, h, w, th, tw, sch.fwd_margin), _build.cascade_table(sch, mode, inverse=False),
    )
    _backend.launches.bump("tiled2d_fwd")
    return ll, lh, hl, hh


def inv2d_tiled_cuda(
    ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor, mode: str, th: int, tw: int,
    scheme="cdf53",
) -> Tensor:
    """Launch ``csrc/tiled2d.cu`` inverse on (B, ...) int32 CUDA bands.
    Replaces ``repro.kernels.tiled2d.inv2d_tiled`` (``_inv_tile_kernel``)."""
    sch = S.get_scheme(scheme)
    _check_tile(th, tw)
    dev = _build.check_tensors("inv2d_tiled", [ll, lh, hl, hh])
    bsz, h, w = band_dims(ll, lh, hl, hh)
    x = ll.new_empty((bsz, h, w))
    _build.launch(
        "tiled2d", "repro_tiled_inv", dev, (ll, lh, hl, hh, x),
        (bsz, h, w, th, tw, sch.inv_margin), _build.cascade_table(sch, mode, inverse=True),
    )
    _backend.launches.bump("tiled2d_inv")
    return x


def fwd2d_tiled(x: Tensor, mode: str, th: int, tw: int, scheme="cdf53"):
    """Tiled forward level over a (B, H, W) int32 batch -> (ll, lh, hl, hh)
    with the reference band shapes: the kernel for a CUDA tensor,
    :func:`fwd2d_tiled_plain` for a CPU tensor."""
    sch = S.get_scheme(scheme)
    _check_tile(th, tw)
    check_level_input(x)
    if x.dtype != torch.int32:
        raise TypeError(f"need an int32 batch, got {x.dtype}")
    _check_windowable(sch, x.shape[1], x.shape[2])
    if _backend.on_cuda(x):
        return fwd2d_tiled_cuda(x, mode, th, tw, sch)
    return fwd2d_tiled_plain(x, mode, th, tw, sch)


def inv2d_tiled(
    ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor, mode: str, th: int, tw: int,
    scheme="cdf53",
) -> Tensor:
    """Tiled inverse level over (B, ...) int32 band batches -> (B, H, W):
    the kernel for CUDA tensors, :func:`inv2d_tiled_plain` for CPU ones."""
    sch = S.get_scheme(scheme)
    _check_tile(th, tw)
    if any(b.dtype != torch.int32 for b in (ll, lh, hl, hh)):
        raise TypeError("need int32 bands")
    _, h, w = band_dims(ll, lh, hl, hh)
    _check_windowable(sch, h, w)
    if _backend.on_cuda(ll):
        return inv2d_tiled_cuda(ll, lh, hl, hh, mode, th, tw, sch)
    return inv2d_tiled_plain(ll, lh, hl, hh, mode, th, tw, sch)
