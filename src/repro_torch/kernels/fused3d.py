"""N-D integer lifting DWT with a 3-D volume engine: kernels, dispatch, API.

Port of ``repro.kernels.fused3d``.  :func:`dwt_fwd_nd` / :func:`dwt_inv_nd`
transform the last ``ndim`` axes, bit-exact against the oracle
(``core.lifting.dwt_fwd_nd``) for every scheme, both rounding modes and
every shape with all transform axes >= 2:

  * ndim 1 and 2 run the 1-D and 2-D engines (``kernels.ops``,
    ``kernels.fused2d``), re-wrapped as :class:`PyramidND` in code order;
  * ndim 3 runs the volume engine below, one level at a time on a
    (B, D, H, W) int32 batch, each level on one of two engines chosen from
    the static shape (:func:`plan_3d`):

      - **slab** (``csrc/slab3d.cu``): the plane axes W and H (band-policy
        math along W, windows along H), then the depth axis in windows of
        TD + 2*halo slices that the kernel reflects itself; two passes
        through device memory per level where the scheme windows along H
        and a strip of whole rows fits a block, else three
        (:func:`slab_geometry`).  Taken where the scheme windows along
        the depth (``scheme.can_window(D)``) and the volume
        is larger than one block's shared memory
        (``backend.whole3d_budget_elems``), or for every such volume when
        ``REPRO_DWT_SLAB`` is set.
      - **whole-volume** (``csrc/whole3d.cu``): band-policy math on all
        three axes, so every scheme and shape works; one thread-block
        cluster of up to 16 blocks per volume where each block's run of
        rows fits its shared memory (:func:`volume_geometry`), otherwise
        three passes through device memory.  A large volume that cannot
        slab (cdf22 anywhere, haar on odd depth) runs here: the
        reference's ``xla`` cliff and its ``BackendDegradeWarning`` have
        no counterpart.

  * ndim > 3 runs the per-level N-D math on the tensor's own device (the
    reference runs jnp math there too; no TPU kernel exists for it).

Each engine is a kernel for a CUDA tensor and its plain PyTorch version
for a CPU tensor, never one in place of the other: on a CUDA tensor a
level launches a kernel or raises.  Every public function takes
``checked=`` (``core/ranges.py``), as in the reference.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lifting as _lift
from repro_torch.core import ranges as _ranges
from repro_torch.core import schemes as S
from repro_torch.core.lifting import PyramidND, check_levels_nd
from repro_torch.kernels import _build
from repro_torch.kernels import backend as _backend
from repro_torch.kernels import fused2d as _f2d
from repro_torch.kernels.fused2d import CLUSTER_MAX, CLUSTER_SIZES
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.ops import _compute_dtype
from repro_torch.obs import NULL, tracer
from repro_torch.obs import _state as _obs

Tensor = torch.Tensor

_N_BANDS_3D = 8  # 2**3 band octants per level, code order (bit j = axis -(j+1))


def _band_dims_3d(d: int, h: int, w: int) -> List[Tuple[int, int, int]]:
    """Per-code (depth, height, width) band shapes for one 3-D level."""
    ev = (d - d // 2, h - h // 2, w - w // 2)
    od = (d // 2, h // 2, w // 2)
    return [
        (
            od[0] if code & 4 else ev[0],  # bit 2: axis -3 (depth)
            od[1] if code & 2 else ev[1],  # bit 1: axis -2
            od[2] if code & 1 else ev[2],  # bit 0: axis -1
        )
        for code in range(_N_BANDS_3D)
    ]


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def check_volume(x: Tensor) -> None:
    """A forward level takes a (B, D >= 2, H >= 2, W >= 2) batch."""
    if x.ndim != 4 or min(x.shape[1:]) < 2:
        raise ValueError(f"need a (B, D>=2, H>=2, W>=2) batch, got {tuple(x.shape)}")


def band_dims(bands: Sequence[Tensor]) -> Tuple[int, int, int, int]:
    """(B, D, H, W) of one level's eight (B, ...) bands; raises unless
    their shapes are the ones a (B, D, H, W) forward level produces."""
    return _band_dims_of(tuple(b.shape for b in bands))


@functools.lru_cache(maxsize=256)
def _band_dims_of(shapes: Tuple[Tuple[int, ...], ...]) -> Tuple[int, int, int, int]:
    if len(shapes) != _N_BANDS_3D or any(len(s) != 4 for s in shapes):
        raise ValueError(f"need 8 (B, d, h, w) bands, got {[tuple(s) for s in shapes]}")
    bsz = shapes[0][0]
    d = shapes[0][1] + shapes[4][1]
    h = shapes[0][2] + shapes[2][2]
    w = shapes[0][3] + shapes[1][3]
    want = [(bsz,) + dim for dim in _band_dims_3d(d, h, w)]
    got = [tuple(s) for s in shapes]
    if got != want or min(d, h, w) < 2:
        raise ValueError(f"band shape mismatch: got {got}, want {want}")
    return bsz, d, h, w


# ---------------------------------------------------------------------------
# Plain versions: the reference's kernel bodies on torch tensors.
# ---------------------------------------------------------------------------


def fwd3d_whole_plain(x: Tensor, mode: str, scheme="cdf53") -> Tuple[Tensor, ...]:
    """One 3-D level of a (B, D, H, W) batch as the code-ordered bands:
    the band-policy math (``_fwd3d_math``), the plain version of the
    whole-volume forward kernel."""
    return tuple(_lift._fwd_nd_level(x, 3, mode, scheme))


def inv3d_whole_plain(bands: Sequence[Tensor], mode: str, scheme="cdf53") -> Tensor:
    """The plain version of the whole-volume inverse kernel."""
    return _lift._inv_nd_level(list(bands), 3, mode, scheme)


def _fwd_slab_math(win: Tensor, mode: str, scheme) -> List[Tensor]:
    """One 3-D level on depth-halo'd (..., TD + 2*halo, H, W) windows: the
    plane axes with band-policy math per depth slice (-1, then -2), the
    depth axis with interior window math."""
    s_r, d_r = S.lift_fwd_axis(win, scheme, axis=-1, mode=mode)
    c0, c2 = S.lift_fwd_axis(s_r, scheme, axis=-2, mode=mode)
    c1, c3 = S.lift_fwd_axis(d_r, scheme, axis=-2, mode=mode)
    out: List[Tensor] = [None] * _N_BANDS_3D  # type: ignore[list-item]
    for code, plane in ((0, c0), (1, c1), (2, c2), (3, c3)):
        out[code], out[code | 4] = S.lift_fwd_axis_ext(plane, scheme, axis=-3, mode=mode)
    return out


def _inv_slab_math(wins: Sequence[Tensor], mode: str, scheme) -> Tensor:
    """Inverse 3-D level from depth-margin-extended band windows."""
    planes = [
        S.lift_inv_axis_ext(wins[c], wins[c | 4], scheme, axis=-3, mode=mode) for c in range(4)
    ]
    s_col = S.lift_inv_axis(planes[0], planes[2], scheme, axis=-2, mode=mode)
    d_col = S.lift_inv_axis(planes[1], planes[3], scheme, axis=-2, mode=mode)
    return S.lift_inv_axis(s_col, d_col, scheme, axis=-1, mode=mode)


def _depth_windows(x: Tensor, rows: np.ndarray) -> Tensor:
    """(B, D', H, W) -> (B, n_slabs, wd, H, W) overlapping depth windows."""
    return x[:, torch.as_tensor(rows, dtype=torch.long, device=x.device)]


def _slab_count(d: int, td: int) -> int:
    return _cdiv(d - d // 2, td // 2)


def fwd3d_slab_plain(x: Tensor, mode: str, td: int, scheme="cdf53") -> Tuple[Tensor, ...]:
    """Plain version of the depth-slab forward level over a (B, D, H, W)
    batch: depth windows gathered through ``reflect_indices``, the slab
    math on them, the bands cropped to their depths."""
    sch = S.get_scheme(scheme)
    halo = sch.halo
    bsz, d, h, w = x.shape
    n_slabs = _slab_count(d, td)
    rows = np.stack([S.reflect_indices(t * td - halo, td + 2 * halo, d) for t in range(n_slabs)])
    bands = _fwd_slab_math(_depth_windows(x, rows), mode, sch)
    return tuple(
        b.reshape((bsz, n_slabs * (td // 2)) + tuple(b.shape[3:]))[:, : dim[0]]
        for b, dim in zip(bands, _band_dims_3d(d, h, w))
    )


def inv3d_slab_plain(bands: Sequence[Tensor], mode: str, td: int, scheme="cdf53") -> Tensor:
    """Plain version of the depth-slab inverse level: band windows through
    ``reflect_entries`` (parity 0 for codes 0-3, the depth-even stream;
    parity 1 for codes 4-7), the inverse slab math, cropped to D."""
    sch = S.get_scheme(scheme)
    m = sch.inv_margin
    bsz, d, h, w = band_dims(bands)
    me = td // 2
    n_slabs = _slab_count(d, td)
    idx = {
        parity: np.stack([S.reflect_entries(t * me - m, me + 2 * m, parity, d)
                          for t in range(n_slabs)])
        for parity in (0, 1)
    }
    wins = [_depth_windows(b, idx[(code >> 2) & 1]) for code, b in enumerate(bands)]
    x = _inv_slab_math(wins, mode, sch)
    return x.reshape(bsz, n_slabs * td, h, w)[:, :d]


# ---------------------------------------------------------------------------
# Kernels (csrc/whole3d.cu, csrc/slab3d.cu).
# ---------------------------------------------------------------------------


def cluster_rows(h: int, c: int) -> int:
    """Rows of the largest share of an H-row slice split over a cluster
    of ``c`` blocks (``csrc/whole3d.cu`` cluster_rows): the ceil(h/2) row
    pairs in runs of whole pairs."""
    return 2 * _cdiv(_cdiv(h, 2), c)


def cluster_fits(d: int, h: int, w: int, c: int, device=None) -> bool:
    """Whether a cluster of ``c`` blocks can hold one (d, h, w) volume:
    at least one row pair a block (c <= ceil(h/2)), each block's share
    (:func:`cluster_rows` rows of every slice) within one block's shared
    memory, and the card co-schedules such a cluster
    (:func:`~repro_torch.kernels.fused2d.card_admits`)."""
    share = cluster_rows(h, c) * d * w
    return (1 <= c <= min(CLUSTER_MAX, _cdiv(h, 2))
            and share <= _backend.whole3d_budget_elems(device)
            and _card_admits(c, 4 * share, device))


_card_admits = functools.partial(_f2d.card_admits, "whole3d")


def _pick_cluster(b: int, d: int, h: int, w: int, device) -> int:
    """Blocks per volume of the whole-volume cluster path, 0 for none
    (:func:`~repro_torch.kernels.fused2d.pick_cluster` over
    :func:`cluster_fits`, a share being the block's rows of every slice),
    the batch's blocks held to the card's SMs."""
    return _f2d.pick_cluster(lambda c: cluster_fits(d, h, w, c, device), b,
                             lambda c: cluster_rows(h, c) * d * w,
                             _backend.budgets(device)["sms"])


def volume_geometry(
    b: int, d: int, h: int, w: int, device: Optional[torch.device] = None
) -> Dict[str, int]:
    """Launch geometry of the whole-volume 3-D kernels for a (b, d, h, w)
    level: ``cluster``, the blocks of the cluster that holds one volume
    (:func:`_pick_cluster`; ``fused`` is 1 when there is one), or 0 for
    the three passes through device memory, whose row pass's ``rb`` /
    ``row_global``, column strips ``cw_h`` (H pass) and ``cw_d`` (D pass),
    0 meaning global scratch, and ``scratch`` entries for the global
    stagings follow."""
    dev = None if device is None else torch.device(device)
    return dict(_volume_geometry(b, d, h, w, dev))


@functools.lru_cache(maxsize=256)
def _volume_geometry(b, d, h, w, device) -> Dict[str, int]:
    cluster = _pick_cluster(b, d, h, w, device)
    rows = _backend.row_geometry(b * d * h, w, device)
    cw_h, cw_d = _backend.strip_width(h, device), _backend.strip_width(d, device)
    wid = (w - w // 2, w // 2)
    planes = [hh * ww for hh in (h - h // 2, h // 2) for ww in wid]
    scratch = max(rows["scratch"], _backend.col_scratch(b * d, h, wid, cw_h),
                  _backend.col_scratch(b, d, planes, cw_d))
    return {
        "cluster": cluster, "fused": int(cluster > 0),
        "rb": rows["rb"], "row_global": rows["row_global"], "cw_h": cw_h, "cw_d": cw_d,
        "scratch": scratch,
    }


def _intermediates(ref: Tensor, b: int, d: int, h: int, w: int):
    """The row bands (sw, dw) and the four planes after the H pass."""
    he, ho, we, wo = h - h // 2, h // 2, w - w // 2, w // 2
    rows = b * d * h
    sw, dw = ref.new_empty((rows, we)), ref.new_empty((rows, wo))
    t = [ref.new_empty((b * d, hh, ww)) for hh, ww in ((he, we), (he, wo), (ho, we), (ho, wo))]
    return sw, dw, t


class _WholePlan(NamedTuple):
    """What one whole-volume call of a shape, scheme and direction needs
    besides its tensors, built once: the geometry; each band's shape,
    strides and offset (in int32 entries, on a 16-byte boundary) into one
    allocation of ``total`` entries; and the launcher's integer arguments,
    the scheme table's address and length last, as ctypes objects
    (``table`` keeps that array alive)."""

    geometry: Dict[str, int]
    bands: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...], int], ...]
    total: int
    ints: Tuple[object, ...]
    table: np.ndarray


@functools.lru_cache(maxsize=256)
def _whole_plan(bsz, d, h, w, sch, mode, inverse, device) -> _WholePlan:
    g = _volume_geometry(bsz, d, h, w, device)
    bands, total = [], 0
    for dim in _band_dims_3d(d, h, w):
        strides = (dim[0] * dim[1] * dim[2], dim[1] * dim[2], dim[2], 1)
        bands.append(((bsz,) + dim, strides, total))
        total += _cdiv(bsz * strides[0], 4) * 4
    table = _build.cascade_table(sch, mode, inverse)
    ints = tuple(ctypes.c_int(v) for v in (bsz, d, h, w, g["cluster"], g["rb"],
                                           g["row_global"], g["cw_h"], g["cw_d"]))
    ints += (ctypes.c_void_p(table.ctypes.data), ctypes.c_int(len(table)))
    return _WholePlan(g, tuple(bands), total, ints, table)


def _at_cluster(plan: _WholePlan, cluster: int) -> _WholePlan:
    """``plan`` with its cluster size forced to ``cluster`` (0: the three
    passes), for the card tests and ``chip_smoke.py``'s sweep; a size the
    shape or the card cannot take raises at the launch."""
    g = dict(plan.geometry, cluster=cluster, fused=int(cluster > 0))
    return plan._replace(geometry=g,
                         ints=plan.ints[:4] + (ctypes.c_int(cluster),) + plan.ints[5:])


def whole_bands(ref: Tensor, plan: _WholePlan) -> Tuple[Tensor, ...]:
    """The eight bands of a forward level: one allocation on ``ref``'s
    device, each band a contiguous view of it on a 16-byte boundary."""
    flat = ref.new_empty((plan.total,))
    return tuple(flat.as_strided(shape, stride, off) for shape, stride, off in plan.bands)


def _work_buffers(ref: Tensor, plan: _WholePlan, b: int, d: int, h: int, w: int):
    """The three passes' row bands, planes and scratch (as addresses;
    the tensors are returned too, to be held until the launch is
    queued); all null for a cluster."""
    if plan.geometry["cluster"]:
        return (0,) * 7, ()
    sw, dw, t = _intermediates(ref, b, d, h, w)
    n = plan.geometry["scratch"]
    scratch = ref.new_empty((n,)) if n else None
    held = (sw, dw, *t, scratch)
    return tuple(_build._ptr(a) for a in held), held


def slab_geometry(
    b: int, d: int, h: int, w: int, td: int, scheme="cdf53", inverse: bool = False,
    device: Optional[torch.device] = None,
) -> Dict[str, int]:
    """Launch geometry of one depth-slab level (``csrc/slab3d.cu``) of a
    (b, d, h, w) batch with slab depth ``td``: the margin ``m`` of the
    direction; ``plane_rows`` R of the fused plane pass (0 where it does
    not apply, :func:`backend.plane_rows`), and then ``passes`` 2;
    otherwise ``passes`` 3 and the row and column passes' ``rb`` /
    ``row_global`` / ``cw_h`` / ``scratch``, as :func:`volume_geometry`
    sizes them; and the depth pass's strip ``cw_s``."""
    dev = None if device is None else torch.device(device)
    return dict(_slab_geometry(b, d, h, w, td, S.get_scheme(scheme), inverse, dev))


@functools.lru_cache(maxsize=256)
def _slab_geometry(b, d, h, w, td, sch, inverse, device) -> Dict[str, int]:
    m = sch.inv_margin if inverse else sch.fwd_margin
    cw_s = _backend.slab_strip(td + 4 * m, device)
    if not cw_s:
        raise ValueError(f"slab depth {td} is too deep for one block's shared memory")
    rows = _backend.plane_rows(h, w, m, sch.can_window(h), device)
    g = {"m": m, "plane_rows": rows, "passes": 2 if rows else 3, "cw_s": cw_s,
         "rb": 1, "row_global": 0, "cw_h": 0, "scratch": 0}
    if not rows:
        rs, cw_h = _backend.row_geometry(b * d * h, w, device), _backend.strip_width(h, device)
        g.update(rb=rs["rb"], row_global=rs["row_global"], cw_h=cw_h,
                 scratch=max(rs["scratch"],
                             _backend.col_scratch(b * d, h, (w - w // 2, w // 2), cw_h)))
    return g


def _slab_args(g: Dict[str, int], bsz: int, d: int, h: int, w: int, td: int) -> Tuple[int, ...]:
    return (bsz, d, h, w, td, g["m"], g["rb"], g["row_global"], g["cw_h"], g["cw_s"],
            g["plane_rows"])


def _slab_buffers(ref: Tensor, g: Dict[str, int], b: int, d: int, h: int, w: int):
    """Device scratch of one slab level: the four planes t0..t3 between
    the plane axes and the depth axis, as addresses in one allocation
    (each on a 16-byte boundary, which the kernels' vector copies need;
    one allocator call instead of four), and the row bands and scratch
    of the row and column passes where they run (None otherwise).  The
    allocation is returned too, to be held until the launch is queued."""
    he, ho, we, wo = h - h // 2, h // 2, w - w // 2, w // 2
    sizes = [b * d * hh * ww for hh, ww in ((he, we), (he, wo), (ho, we), (ho, wo))]
    offsets = [0]
    for n in sizes[:-1]:
        offsets.append(offsets[-1] + _cdiv(n, 4) * 4)
    planes = ref.new_empty((offsets[-1] + sizes[-1],))
    t = [planes.data_ptr() + 4 * o for o in offsets]
    sw = dw = None
    if not g["plane_rows"]:
        sw, dw = ref.new_empty((b * d * h, we)), ref.new_empty((b * d * h, wo))
    scratch = ref.new_empty((g["scratch"],)) if g["scratch"] else None
    return planes, sw, dw, t, scratch


def fwd3d_whole_cuda(x: Tensor, mode: str, scheme="cdf53") -> Tuple[Tensor, ...]:
    """Launch ``csrc/whole3d.cu`` forward on a (B, D, H, W) int32 CUDA
    batch: one cluster of :func:`volume_geometry`'s ``cluster`` blocks per
    volume, or the three passes.  The bands are views of one allocation
    (:func:`whole_bands`).  Replaces ``repro.kernels.fused3d._fwd3d_pallas``
    (``_fwd3d_kernel``)."""
    sch = S.get_scheme(scheme)
    check_volume(x)
    bsz, d, h, w = x.shape
    return _whole_fwd(x, _whole_plan(bsz, d, h, w, sch, mode, False, x.device))


def inv3d_whole_cuda(bands: Sequence[Tensor], mode: str, scheme="cdf53") -> Tensor:
    """Launch ``csrc/whole3d.cu`` inverse on eight (B, ...) int32 CUDA
    bands, at the same geometry as the forward.  Replaces
    ``repro.kernels.fused3d._inv3d_pallas`` (``_inv3d_kernel``)."""
    sch = S.get_scheme(scheme)
    bsz, d, h, w = band_dims(bands)
    return _whole_inv(bands, _whole_plan(bsz, d, h, w, sch, mode, True, bands[0].device))


def _whole_fwd(x: Tensor, plan: _WholePlan) -> Tuple[Tensor, ...]:
    """The forward launch of ``plan`` (from :func:`_whole_plan`, or
    :func:`_at_cluster` to force a cluster size) on ``x``."""
    dev = _build.check_tensors("fwd3d_whole", [x])
    bsz, d, h, w = x.shape
    bands = whole_bands(x, plan)
    (sw, dw, *t, scratch), _held = _work_buffers(x, plan, bsz, d, h, w)
    _build.call("whole3d", "repro_whole3d_fwd", (
        dev, x.data_ptr(), sw, dw, *t, *(b.data_ptr() for b in bands), scratch, *plan.ints,
        _build.current_stream_handle(dev)))
    _backend.launches.bump("whole3d_fwd")
    return bands


def _whole_inv(bands: Sequence[Tensor], plan: _WholePlan) -> Tensor:
    """The inverse launch of ``plan`` on eight bands."""
    dev = _build.check_tensors("inv3d_whole", bands)
    bsz, d, h, w = band_dims(bands)
    x = bands[0].new_empty((bsz, d, h, w))
    (sw, dw, *t, scratch), _held = _work_buffers(x, plan, bsz, d, h, w)
    _build.call("whole3d", "repro_whole3d_inv", (
        dev, *(b.data_ptr() for b in bands), *t, sw, dw, x.data_ptr(), scratch, *plan.ints,
        _build.current_stream_handle(dev)))
    _backend.launches.bump("whole3d_inv")
    return x


def fwd3d_slab_cuda(x: Tensor, mode: str, td: int, scheme="cdf53") -> Tuple[Tensor, ...]:
    """Launch ``csrc/slab3d.cu`` forward on a (B, D, H, W) int32 CUDA batch
    with slab depth ``td``: the plane pass and the depth pass, or the row,
    column and depth passes (:func:`slab_geometry`).  Replaces
    ``repro.kernels.fused3d.fwd3d_slab`` (``_fwd_slab_kernel``)."""
    sch = S.get_scheme(scheme)
    _check_slab(td)
    check_volume(x)
    dev = _build.check_tensors("fwd3d_slab", [x])
    bsz, d, h, w = x.shape
    bands = [x.new_empty((bsz,) + dim) for dim in _band_dims_3d(d, h, w)]
    g = slab_geometry(bsz, d, h, w, td, sch, inverse=False, device=x.device)
    _planes, sw, dw, t, scratch = _slab_buffers(x, g, bsz, d, h, w)
    _build.launch(
        "slab3d", "repro_slab3d_fwd", dev, [x, sw, dw, *t, *bands, scratch],
        _slab_args(g, bsz, d, h, w, td), _build.cascade_table(sch, mode, inverse=False),
    )
    _backend.launches.bump("slab3d_fwd")
    return tuple(bands)


def inv3d_slab_cuda(bands: Sequence[Tensor], mode: str, td: int, scheme="cdf53") -> Tensor:
    """Launch ``csrc/slab3d.cu`` inverse on eight (B, ...) int32 CUDA bands:
    the depth pass, then the plane pass or the column and row passes.
    Replaces ``repro.kernels.fused3d.inv3d_slab`` (``_inv_slab_kernel``)."""
    sch = S.get_scheme(scheme)
    _check_slab(td)
    dev = _build.check_tensors("inv3d_slab", list(bands))
    bsz, d, h, w = band_dims(bands)
    ref = bands[0]
    x = ref.new_empty((bsz, d, h, w))
    g = slab_geometry(bsz, d, h, w, td, sch, inverse=True, device=ref.device)
    _planes, sw, dw, t, scratch = _slab_buffers(ref, g, bsz, d, h, w)
    _build.launch(
        "slab3d", "repro_slab3d_inv", dev, [*bands, *t, sw, dw, x, scratch],
        _slab_args(g, bsz, d, h, w, td), _build.cascade_table(sch, mode, inverse=True),
    )
    _backend.launches.bump("slab3d_inv")
    return x


# ---------------------------------------------------------------------------
# Wrappers: CUDA tensor -> kernel, CPU tensor -> plain version.
# ---------------------------------------------------------------------------


def _check_slab(td: int) -> None:
    if td < 2 or td % 2:
        raise ValueError(f"slab depth must be even and >= 2, got {td}")


def _check_int32(tensors: Sequence[Tensor]) -> None:
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"need int32 tensors, got {sorted({str(t.dtype) for t in tensors})}")


def _check_slabbable(sch: S.LiftingScheme, d: int) -> None:
    if not sch.can_window(d):
        raise ValueError(
            f"the depth-slab engine needs a depth scheme {sch.name!r} can window, got {d}"
        )


def fwd3d_whole(x: Tensor, mode: str, scheme="cdf53") -> Tuple[Tensor, ...]:
    """Whole-volume forward level over a (B, D, H, W) int32 batch: the
    kernel for a CUDA tensor, :func:`fwd3d_whole_plain` for a CPU tensor."""
    check_volume(x)
    _check_int32([x])
    if _backend.on_cuda(x):
        return fwd3d_whole_cuda(x, mode, scheme)
    return fwd3d_whole_plain(x, mode, scheme)


def inv3d_whole(bands: Sequence[Tensor], mode: str, scheme="cdf53") -> Tensor:
    """Whole-volume inverse level over eight (B, ...) int32 bands."""
    _check_int32(bands)
    band_dims(bands)
    if _backend.on_cuda(bands[0]):
        return inv3d_whole_cuda(bands, mode, scheme)
    return inv3d_whole_plain(bands, mode, scheme)


def fwd3d_slab(x: Tensor, mode: str, td: int, scheme="cdf53") -> Tuple[Tensor, ...]:
    """Depth-slab forward level over a (B, D, H, W) int32 batch: the kernel
    for a CUDA tensor, :func:`fwd3d_slab_plain` for a CPU tensor."""
    sch = S.get_scheme(scheme)
    _check_slab(td)
    check_volume(x)
    _check_int32([x])
    _check_slabbable(sch, x.shape[1])
    if _backend.on_cuda(x):
        return fwd3d_slab_cuda(x, mode, td, sch)
    return fwd3d_slab_plain(x, mode, td, sch)


def inv3d_slab(bands: Sequence[Tensor], mode: str, td: int, scheme="cdf53") -> Tensor:
    """Depth-slab inverse level over eight (B, ...) int32 bands."""
    sch = S.get_scheme(scheme)
    _check_slab(td)
    _check_int32(bands)
    _check_slabbable(sch, band_dims(bands)[1])
    if _backend.on_cuda(bands[0]):
        return inv3d_slab_cuda(bands, mode, td, sch)
    return inv3d_slab_plain(bands, mode, td, sch)


# ---------------------------------------------------------------------------
# Level dispatch: slab where the depth windows and the volume is past one
# block (or REPRO_DWT_SLAB is set), whole-volume otherwise.
# ---------------------------------------------------------------------------


def _use_slab(d: int, h: int, w: int, sch: S.LiftingScheme, device=None) -> bool:
    return sch.can_window(d) and (
        _backend.slab_forced() or d * h * w > _backend.whole3d_budget_elems(device)
    )


def _level_span(level: int, slab: bool, direction: str):
    """The ``kernels.level`` span of one 3-D level (1 is the finest)."""
    return tracer.record("kernels.level", "kernels", level=level,
                         engine="slab3d" if slab else "whole3d", direction=direction)


def _fwd3d_level(x4: Tensor, sch: S.LiftingScheme, mode: str, level: int) -> Tuple[Tensor, ...]:
    """Forward level ``level`` on a (B, D, H, W) int32 batch."""
    bsz, d, h, w = x4.shape
    if bsz == 0:
        return tuple(x4.new_empty((0,) + dim) for dim in _band_dims_3d(d, h, w))
    slab = _use_slab(d, h, w, sch, x4.device)
    with _level_span(level, slab, "fwd") if _obs.kernels else NULL:
        if slab:
            return fwd3d_slab(x4, mode, _backend.pick_slab(d, h, w, sch.halo, x4.device), sch)
        return fwd3d_whole(x4, mode, sch)


def _inv3d_level(bands: Sequence[Tensor], sch: S.LiftingScheme, mode: str, level: int) -> Tensor:
    """Inverse level ``level`` from eight (B, ...) int32 bands."""
    bsz, d, h, w = band_dims(bands)
    if bsz == 0:
        return bands[0].new_empty((0, d, h, w))
    dev = bands[0].device
    slab = _use_slab(d, h, w, sch, dev)
    with _level_span(level, slab, "inv") if _obs.kernels else NULL:
        if slab:
            return inv3d_slab(bands, mode, _backend.pick_slab(d, h, w, sch.halo, dev), sch)
        return inv3d_whole(bands, mode, sch)


def plan_3d(d: int, h: int, w: int, device="cuda", scheme="cdf53") -> str:
    """Name the path a (d, h, w) level takes on ``device``: ``whole-cuda``,
    ``slab-cuda``, ``whole-torch`` or ``slab-torch`` (the ``-torch`` names
    are the plain versions a CPU tensor runs).  The default is the card;
    without one it raises."""
    dev = _backend.resolve_device(device)
    kind = "slab" if _use_slab(d, h, w, S.get_scheme(scheme), dev) else "whole"
    return f"{kind}-{'cuda' if dev.type == 'cuda' else 'torch'}"


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


def _flat(a: Tensor, nd: int) -> Tensor:
    """(*lead, *trailing) -> contiguous (B, *trailing) in the compute dtype.
    B is the product of the lead dims, not ``-1``: that cannot be
    inferred when a trailing dim is 0."""
    b = math.prod(a.shape[:a.ndim - nd])
    return a.reshape((b,) + tuple(a.shape[a.ndim - nd:])).to(_compute_dtype(a.dtype)).contiguous()


def _fwd_nd_via_2d(x: Tensor, levels: int, mode: str, sch) -> PyramidND:
    p2 = _f2d.dwt_fwd_2d_multi(x, levels=levels, mode=mode, scheme=sch, checked=False)
    # Pyramid2D stores (lh, hl, hh); code order is (hl, lh, hh) — bit 0
    # (highpass along -1) first
    return PyramidND(approx=p2.ll, details=tuple((hl, lh, hh) for lh, hl, hh in p2.details))


def _inv_nd_via_2d(pyr: PyramidND, mode: str, sch) -> Tensor:
    p2 = _lift.Pyramid2D(ll=pyr.approx,
                         details=tuple((lvl[1], lvl[0], lvl[2]) for lvl in pyr.details))
    return _f2d.dwt_inv_2d_multi(p2, mode=mode, scheme=sch, checked=False)


def dwt_fwd_nd(
    x: Tensor, levels: int = 1, mode: str = "paper", scheme="cdf53", ndim: int = 3,
    checked=None,
) -> PyramidND:
    """Multi-level N-D forward transform over the last ``ndim`` axes, on
    the device ``x`` lives on.

    ndim 3 is the volume engine (one block per volume within a block's
    shared memory, depth slabs beyond it where the scheme windows along
    the depth, otherwise one cluster of blocks per volume, or three
    passes through device memory where no cluster holds it); ndim 1 and
    2 run the 1-D and 2-D engines; any registered scheme, any axis
    lengths >= 2 (``levels=0`` is the identity pyramid).  Bit-exact
    against ``core.lifting.dwt_fwd_nd``.  ``checked=True`` (or
    ``REPRO_DWT_CHECKED=1``) certifies the data against the derived range
    bounds and raises ``IntegerOverflowError`` instead of ever returning
    wrapped bands (``core/ranges.py``).
    """
    with _backend.call_span("fwd", ndim, levels, x.shape[:-ndim]) if _obs.kernels else NULL:
        S.check_mode(mode)
        sch = S.get_scheme(scheme)
        if ndim < 1:
            raise ValueError(f"ndim must be >= 1, got {ndim}")
        if x.ndim < ndim:
            raise ValueError(f"need >= {ndim} axes, got shape {tuple(x.shape)}")
        check_levels_nd(tuple(x.shape[-ndim:]), levels)
        if _ranges.checked_enabled(checked):
            return _ranges.run_checked(
                lambda a: dwt_fwd_nd(a, levels=levels, mode=mode, scheme=sch, ndim=ndim,
                                     checked=False),
                x, scheme=sch, levels=levels, mode=mode, ndim=ndim, label="kernels.dwt_fwd_nd",
            )
        if ndim == 1:
            pyr = _ops.dwt_fwd(x, levels=levels, mode=mode, scheme=sch, checked=False)
            return PyramidND(approx=pyr.approx, details=tuple((d,) for d in pyr.details))
        if ndim == 2:
            return _fwd_nd_via_2d(x, levels, mode, sch)
        lead = tuple(x.shape[:-ndim])
        approx = _flat(x, ndim)
        details: List[Tuple[Tensor, ...]] = []
        for i in range(levels):
            if ndim == 3:
                bands = _fwd3d_level(approx, sch, mode, i + 1)
            else:
                bands = tuple(_lift._fwd_nd_level(approx, ndim, mode, sch))
            approx = bands[0]
            details.append(tuple(bands[1:]))

        def unlead(a: Tensor) -> Tensor:
            return a.reshape(lead + tuple(a.shape[1:]))

        return PyramidND(
            approx=unlead(approx),
            details=tuple(tuple(unlead(b) for b in lvl) for lvl in reversed(details)),
        )


def dwt_inv_nd(pyr: PyramidND, mode: str = "paper", scheme="cdf53", checked=None) -> Tensor:
    """Inverse of :func:`dwt_fwd_nd`; band shapes are validated per level
    before any launch, so a malformed pyramid raises the reference's
    ``ValueError`` on every device."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if not pyr.details:
        return _lift.promote_narrow(pyr.approx)
    ndim = pyr.ndim  # validates the band count
    with (_backend.call_span("inv", ndim, pyr.levels, pyr.approx.shape[:-ndim])
          if _obs.kernels else NULL):
        if _ranges.checked_enabled(checked):
            return _ranges.run_checked_inv(
                lambda p: dwt_inv_nd(p, mode=mode, scheme=sch, checked=False),
                pyr, scheme=sch, levels=pyr.levels, mode=mode, ndim=ndim,
                label="kernels.dwt_inv_nd",
            )
        if ndim == 1:
            wp = _lift.WaveletPyramid(approx=pyr.approx,
                                      details=tuple(lvl[0] for lvl in pyr.details))
            return _ops.dwt_inv(wp, mode=mode, scheme=sch, checked=False)
        if ndim == 2:
            return _inv_nd_via_2d(pyr, mode, sch)
        if ndim == 3:  # validate band geometry coarsest-first
            d, h, w = pyr.approx.shape[-3:]
            for lvl in pyr.details:
                dims = _band_dims_3d(d + lvl[3].shape[-3], h + lvl[1].shape[-2],
                                     w + lvl[0].shape[-1])
                for code in range(1, _N_BANDS_3D):
                    if tuple(lvl[code - 1].shape[-3:]) != dims[code]:
                        raise ValueError(
                            f"band shape mismatch at approx={(d, h, w)}: code {code} is "
                            f"{tuple(lvl[code - 1].shape[-3:])}, want {dims[code]}"
                        )
                d, h, w = d + lvl[3].shape[-3], h + lvl[1].shape[-2], w + lvl[0].shape[-1]
        lead = tuple(pyr.approx.shape[:-ndim])
        x = _flat(pyr.approx, ndim)
        for k, lvl in enumerate(pyr.details):  # coarsest first
            bands = [x] + [_flat(b, ndim) for b in lvl]
            if ndim == 3:
                x = _inv3d_level(bands, sch, mode, pyr.levels - k)
            else:
                x = _lift._inv_nd_level(bands, ndim, mode, sch)
        return x.reshape(lead + tuple(x.shape[1:]))
