"""2-D integer lifting DWT: whole-image kernels, level dispatch, pyramids.

Port of ``repro.kernels.fused2d``.  One level of the 2-D transform over
a (B, H, W) batch runs on one of two engines, chosen per level from the
static shape (:func:`plan_2d`):

  * **tiled** (``kernels/tiled2d.py``) — one pass over device memory with
    halo'd tiles; taken for images larger than one block's shared memory
    (``backend.whole_budget_elems``), or for every tileable image when
    ``REPRO_DWT_TILE`` is set.  Only schemes that window along both axes
    (``scheme.can_window``) can take it.
  * **whole-image** (this module) — a row pass then a column pass, each
    block staging whole lines in shared memory with band-policy reads at
    the borders.  It takes every scheme and every shape down to 2x2, with
    no size cap, so an untileable scheme (cdf22; haar on odd sizes) stays
    on a kernel at any size.

Each engine is a kernel for a CUDA tensor and its plain PyTorch version
for a CPU tensor (the whole-image plain version is the oracle,
``core.lifting``).  The reference's over-budget in-graph route and its
XLA recompute on kernel failure have no counterpart: on a CUDA tensor a
level launches a kernel or raises.

:func:`dwt_fwd_2d_multi` / :func:`dwt_inv_2d_multi` chain the levels of
the Mallat pyramid, fine levels tiled and coarse levels whole-image.
Every path reproduces ``core.lifting`` (and so ``repro``) bit for bit,
for every scheme, both rounding modes and every shape >= (2, 2).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import lifting as _lift
from repro_torch.core import schemes as S
from repro_torch.core.lifting import Bands2D, Pyramid2D, check_levels_2d
from repro_torch.kernels import _build
from repro_torch.kernels import backend as _backend
from repro_torch.kernels import tiled2d as _tiled
from repro_torch.kernels.ops import _compute_dtype

Tensor = torch.Tensor


def _fwd2d_math(x: Tensor, mode: str, scheme="cdf53"):
    """One reference 2-D level (``core.lifting.dwt_fwd_2d``) as a tuple —
    the plain version of the whole-image forward kernel."""
    b = _lift.dwt_fwd_2d(x, mode=mode, scheme=scheme)
    return b.ll, b.lh, b.hl, b.hh


def _inv2d_math(ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor, mode: str, scheme="cdf53"):
    """The plain version of the whole-image inverse kernel."""
    return _lift.dwt_inv_2d(Bands2D(ll=ll, lh=lh, hl=hl, hh=hh), mode=mode, scheme=scheme)


# ---------------------------------------------------------------------------
# Whole-image kernels (csrc/whole2d.cu).
# ---------------------------------------------------------------------------

# a row-pass block stages about this many samples (16 KB) of whole rows
_ROW_BLOCK_ELEMS = 4096
_COL_STRIP = 32  # columns per column-pass block: one warp's worth


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def whole_geometry(
    b: int, h: int, w: int, device: Optional[torch.device] = None
) -> Dict[str, int]:
    """Launch geometry of the whole-image kernels for a (b, h, w) level.

    ``rb`` rows per row-pass block; ``cw`` columns per column-pass strip,
    halved until the strip's full height fits one block's shared memory.
    A row (or a one-column strip) too long for shared memory is staged in
    a global scratch buffer instead (``row_global`` / ``col_global``) of
    ``scratch`` int32 entries, shared by both passes.
    """
    limit = _backend.budgets(device)["smem_per_block"]
    row_global = int(w * 4 > limit)
    rb = 1 if row_global else max(1, min(h, _ROW_BLOCK_ELEMS // w))
    cw = _COL_STRIP
    while cw > 1 and h * cw * 4 > limit:
        cw //= 2
    col_global = int(h * cw * 4 > limit)
    if col_global:
        cw = _COL_STRIP
    scratch = 0
    if row_global:
        scratch = _cdiv(h, rb) * b * rb * w
    if col_global:
        strips = _cdiv(w - w // 2, cw) + _cdiv(w // 2, cw)
        scratch = max(scratch, strips * b * h * cw)
    return {"rb": rb, "row_global": row_global, "cw": cw, "col_global": col_global,
            "scratch": scratch}


def _geometry_args(g: Dict[str, int]) -> Tuple[int, ...]:
    return (g["rb"], g["row_global"], g["cw"], g["col_global"])


def fwd2d_whole_cuda(x: Tensor, mode: str, scheme="cdf53"):
    """Launch ``csrc/whole2d.cu`` forward on a (B, H, W) int32 CUDA batch.
    Replaces ``repro.kernels.fused2d._fwd2d_pallas`` (``_fwd2d_kernel``)."""
    sch = S.get_scheme(scheme)
    _tiled.check_level_input(x)
    dev = _build.check_tensors("fwd2d_whole", [x])
    bsz, h, w = x.shape
    h_e, w_e, h_o, w_o = h - h // 2, w - w // 2, h // 2, w // 2
    s_r, d_r = x.new_empty((bsz, h, w_e)), x.new_empty((bsz, h, w_o))
    ll, lh = x.new_empty((bsz, h_e, w_e)), x.new_empty((bsz, h_o, w_e))
    hl, hh = x.new_empty((bsz, h_e, w_o)), x.new_empty((bsz, h_o, w_o))
    g = whole_geometry(bsz, h, w, x.device)
    scratch = x.new_empty((g["scratch"],)) if g["scratch"] else None
    _build.launch(
        "whole2d", "repro_whole_fwd", dev, (x, s_r, d_r, ll, lh, hl, hh, scratch),
        (bsz, h, w) + _geometry_args(g), _build.cascade_table(sch, mode, inverse=False),
    )
    _backend.launches.bump("whole2d_fwd")
    return ll, lh, hl, hh


def inv2d_whole_cuda(ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor, mode: str,
                     scheme="cdf53") -> Tensor:
    """Launch ``csrc/whole2d.cu`` inverse on (B, ...) int32 CUDA bands.
    Replaces ``repro.kernels.fused2d._inv2d_pallas`` (``_inv2d_kernel``)."""
    sch = S.get_scheme(scheme)
    dev = _build.check_tensors("inv2d_whole", [ll, lh, hl, hh])
    bsz, h, w = _tiled.band_dims(ll, lh, hl, hh)
    s_r, d_r = ll.new_empty((bsz, h, w - w // 2)), ll.new_empty((bsz, h, w // 2))
    x = ll.new_empty((bsz, h, w))
    g = whole_geometry(bsz, h, w, ll.device)
    scratch = ll.new_empty((g["scratch"],)) if g["scratch"] else None
    _build.launch(
        "whole2d", "repro_whole_inv", dev, (ll, lh, hl, hh, s_r, d_r, x, scratch),
        (bsz, h, w) + _geometry_args(g), _build.cascade_table(sch, mode, inverse=True),
    )
    _backend.launches.bump("whole2d_inv")
    return x


def fwd2d_whole(x: Tensor, mode: str, scheme="cdf53"):
    """Whole-image forward level over a (B, H, W) int32 batch: the kernel
    for a CUDA tensor, :func:`_fwd2d_math` for a CPU tensor."""
    _tiled.check_level_input(x)
    if x.dtype != torch.int32:
        raise TypeError(f"need an int32 batch, got {x.dtype}")
    if _backend.on_cuda(x):
        return fwd2d_whole_cuda(x, mode, scheme)
    return _fwd2d_math(x, mode, scheme)


def inv2d_whole(ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor, mode: str,
                scheme="cdf53") -> Tensor:
    """Whole-image inverse level over (B, ...) int32 bands: the kernel for
    CUDA tensors, :func:`_inv2d_math` for CPU tensors."""
    if any(b.dtype != torch.int32 for b in (ll, lh, hl, hh)):
        raise TypeError("need int32 bands")
    _tiled.band_dims(ll, lh, hl, hh)
    if _backend.on_cuda(ll):
        return inv2d_whole_cuda(ll, lh, hl, hh, mode, scheme)
    return _inv2d_math(ll, lh, hl, hh, mode, scheme)


# ---------------------------------------------------------------------------
# Level dispatch: tiled past the whole-image budget (or when forced),
# whole-image otherwise — a kernel either way on a CUDA tensor.
# ---------------------------------------------------------------------------


def _can_tile(h: int, w: int, sch: S.LiftingScheme) -> bool:
    return sch.can_window(h) and sch.can_window(w)


def _use_tiled(h: int, w: int, sch: S.LiftingScheme, device=None) -> bool:
    return _can_tile(h, w, sch) and (
        _backend.tile_forced() or h * w > _backend.whole_budget_elems(device)
    )


def _fwd2d_level(x3: Tensor, sch: S.LiftingScheme, mode: str):
    h, w = x3.shape[-2], x3.shape[-1]
    if _use_tiled(h, w, sch, x3.device):
        th, tw = _backend.pick_tile(h, w, sch.halo, x3.device)
        return _tiled.fwd2d_tiled(x3, mode, th, tw, sch)
    return fwd2d_whole(x3, mode, sch)


def _inv2d_level(ll3, lh3, hl3, hh3, sch: S.LiftingScheme, mode: str):
    h = ll3.shape[-2] + lh3.shape[-2]
    w = ll3.shape[-1] + hl3.shape[-1]
    if _use_tiled(h, w, sch, ll3.device):
        th, tw = _backend.pick_tile(h, w, sch.halo, ll3.device)
        return _tiled.inv2d_tiled(ll3, lh3, hl3, hh3, mode, th, tw, sch)
    return inv2d_whole(ll3, lh3, hl3, hh3, mode, sch)


def plan_2d(h: int, w: int, device="cpu", scheme="cdf53") -> str:
    """Name the path a (h, w) level takes on ``device``: ``whole-cuda``,
    ``tiled-cuda``, ``whole-torch`` or ``tiled-torch`` (the ``-torch``
    names are the plain versions a CPU tensor runs)."""
    dev = torch.device(device)
    kind = "tiled" if _use_tiled(h, w, S.get_scheme(scheme), dev) else "whole"
    return f"{kind}-{'cuda' if dev.type == 'cuda' else 'torch'}"


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


def _flat(a: Tensor, lead: Tuple[int, ...]) -> Tensor:
    """(*lead, h, w) -> contiguous (B, h, w) in the compute dtype."""
    return a.reshape((-1,) + tuple(a.shape[len(lead):])).to(_compute_dtype(a.dtype)).contiguous()


def dwt_fwd_2d(x: Tensor, mode: str = "paper", scheme="cdf53") -> Bands2D:
    """One 2-D level over the last two axes (rows then columns), on the
    device ``x`` lives on."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if x.ndim < 2 or x.shape[-1] < 2 or x.shape[-2] < 2:
        raise ValueError(f"need a (..., H>=2, W>=2) input, got {tuple(x.shape)}")
    lead = tuple(x.shape[:-2])
    bands = _fwd2d_level(_flat(x, lead), sch, mode)
    return Bands2D(*(b.reshape(lead + tuple(b.shape[1:])) for b in bands))


def dwt_inv_2d(bands: Bands2D, mode: str = "paper", scheme="cdf53") -> Tensor:
    """Inverse of :func:`dwt_fwd_2d` (columns then rows)."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    lead = tuple(bands.ll.shape[:-2])
    x = _inv2d_level(*(_flat(b, lead) for b in bands), sch, mode)
    return x.reshape(lead + tuple(x.shape[1:]))


def dwt_fwd_2d_multi(
    x: Tensor, levels: int = 1, mode: str = "paper", scheme="cdf53"
) -> Pyramid2D:
    """Multi-level 2-D forward transform (Mallat pyramid), fine levels
    tiled and coarse levels whole-image, on the device ``x`` lives on."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if x.ndim < 2:
        raise ValueError(f"need a (..., H, W) input, got {tuple(x.shape)}")
    check_levels_2d(x.shape[-2], x.shape[-1], levels)
    lead = tuple(x.shape[:-2])
    ll = _flat(x, lead)
    details: List[Tuple[Tensor, Tensor, Tensor]] = []
    for _ in range(levels):
        ll, lh, hl, hh = _fwd2d_level(ll, sch, mode)
        details.append((lh, hl, hh))

    def unlead(a: Tensor) -> Tensor:
        return a.reshape(lead + tuple(a.shape[1:]))

    return Pyramid2D(
        ll=unlead(ll),
        details=tuple(tuple(unlead(b) for b in lvl) for lvl in reversed(details)),
    )


def dwt_inv_2d_multi(pyr: Pyramid2D, mode: str = "paper", scheme="cdf53") -> Tensor:
    """Inverse of :func:`dwt_fwd_2d_multi`."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    ll = pyr.ll
    h, w = ll.shape[-2], ll.shape[-1]
    for lh, hl, hh in pyr.details:  # validate band geometry coarsest-first
        if (
            lh.shape[-2] not in (h, h - 1)
            or hl.shape[-1] not in (w, w - 1)
            or hl.shape[-2] != h
            or lh.shape[-1] != w
            or hh.shape[-2:] != (lh.shape[-2], hl.shape[-1])
        ):
            raise ValueError(
                f"band shape mismatch at ll={(h, w)}: lh={tuple(lh.shape[-2:])}, "
                f"hl={tuple(hl.shape[-2:])}, hh={tuple(hh.shape[-2:])}"
            )
        h, w = h + lh.shape[-2], w + hl.shape[-1]
    lead = tuple(ll.shape[:-2])
    x = _flat(ll, lead)
    for lh, hl, hh in pyr.details:  # coarsest first
        x = _inv2d_level(x, _flat(lh, lead), _flat(hl, lead), _flat(hh, lead), sch, mode)
    return x.reshape(lead + tuple(x.shape[1:]))
