"""2-D integer lifting DWT: whole-image kernels, level dispatch, pyramids.

Port of ``repro.kernels.fused2d``.  One level of the 2-D transform over
a (B, H, W) batch runs on one of two engines, chosen per level from the
static shape (:func:`plan_2d`):

  * **tiled** (``kernels/tiled2d.py``) — one pass over device memory with
    halo'd tiles; taken for images larger than one block's shared memory
    (``backend.whole_budget_elems``), or for every tileable image when
    ``REPRO_DWT_TILE`` is set.  Only schemes that window along both axes
    (``scheme.can_window``) can take it.
  * **whole-image** (this module) — one thread-block cluster of up to 16
    blocks per image, each block a run of whole rows in its shared memory
    (W lifted there, H across the cluster), band-policy reads at the
    borders; a run of consecutive whole-image levels is one launch
    (:func:`chain_launches`).  An image no cluster holds takes a row pass
    and a column pass through device memory.  It takes every scheme and
    every shape down to 2x2, with no size cap, so an untileable scheme
    (cdf22; haar on odd sizes) stays on a kernel at any size.

Each engine is a kernel for a CUDA tensor and its plain PyTorch version
for a CPU tensor (the whole-image plain version is the oracle,
``core.lifting``).  The reference's over-budget in-graph route and its
XLA recompute on kernel failure have no counterpart: on a CUDA tensor a
level launches a kernel or raises.

:func:`dwt_fwd_2d_multi` / :func:`dwt_inv_2d_multi` chain the levels of
the Mallat pyramid, fine levels tiled and each run of coarse levels one
whole-image call (:func:`level_runs`).
Every path reproduces ``core.lifting`` (and so ``repro``) bit for bit,
for every scheme, both rounding modes and every shape >= (2, 2).  Every
public function takes ``checked=`` (``core/ranges.py``), as in the
reference.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lifting as _lift
from repro_torch.core import ranges as _ranges
from repro_torch.core import schemes as S
from repro_torch.core.lifting import Bands2D, Pyramid2D, check_levels_2d
from repro_torch.kernels import _build
from repro_torch.kernels import backend as _backend
from repro_torch.kernels import tiled2d as _tiled
from repro_torch.kernels.ops import _compute_dtype
from repro_torch.obs import NULL, tracer
from repro_torch.obs import _state as _obs

Tensor = torch.Tensor


def _fwd2d_math(x: Tensor, mode: str, scheme="cdf53"):
    """One reference 2-D level (``core.lifting.dwt_fwd_2d``) as a tuple —
    the plain version of the whole-image forward kernel."""
    b = _lift.dwt_fwd_2d(x, mode=mode, scheme=scheme, checked=False)
    return b.ll, b.lh, b.hl, b.hh


def _inv2d_math(ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor, mode: str, scheme="cdf53"):
    """The plain version of the whole-image inverse kernel."""
    return _lift.dwt_inv_2d(Bands2D(ll=ll, lh=lh, hl=hl, hh=hh), mode=mode, scheme=scheme,
                           checked=False)


# ---------------------------------------------------------------------------
# Whole-image kernels (csrc/whole2d.cu).
# ---------------------------------------------------------------------------

# A cluster of at most 16 blocks holds one image or volume (8 is the
# portable size; 9-16 need the card's non-portable opt-in); one launch
# runs at most 16 levels (csrc/whole2d.cu kMaxChain).
CLUSTER_MAX = 16
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CHAIN_MAX = 16
# a block's share is cut no finer than this many samples: below it the
# cluster barriers of a finer split cost more than the block's lifting
# saves (the c sweeps of tools/whole3d_anatomy.py, PERF.md)
CLUSTER_MIN_SHARE = 256


def _cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def chain_groups(h: int, levels: int) -> int:
    """Row groups of a chain of ``levels`` levels of an h-row image
    (``csrc/whole2d.cu`` chain_groups): ceil(h / 2^levels), the same count
    at every level, a group being 2^(levels - k) rows at level k.  Block r
    of a cluster of c owns groups [r * G / c, (r + 1) * G / c), so its
    rows start on an even row at every level and its LL rows are its rows
    of the next level."""
    return _cdiv(h, 1 << levels)


def chain_share(h: int, w: int, levels: int, c: int) -> int:
    """Int32 entries of shared memory one block of a cluster of ``c``
    holds for a chain of ``levels`` levels from an (h, w) image
    (``csrc/whole2d.cu`` chain_entries): its largest level-0 share and,
    past one level, its largest level-1 share beside it."""
    per = _cdiv(chain_groups(h, levels), c)
    n = (per << levels) * w
    if levels > 1:
        n += (per << (levels - 1)) * _cdiv(w, 2)
    return n


def chain_fits(h: int, w: int, levels: int, c: int, device=None) -> bool:
    """Whether a cluster of ``c`` blocks can run a chain of ``levels``
    levels from one (h, w) image: at least one row group a block, each
    block's share (:func:`chain_share`) within one block's shared memory,
    and the card co-schedules such a cluster (:func:`card_admits`)."""
    share = chain_share(h, w, levels, c)
    return (1 <= c <= min(CLUSTER_MAX, chain_groups(h, levels))
            and share <= _backend.whole_budget_elems(device)
            and _card_admits(c, 4 * share, device))


def card_admits(lib: str, c: int, nbytes: int, device) -> bool:
    """Whether the card runs the cluster kernels of ``csrc/<lib>.cu`` in
    clusters of ``c`` blocks of ``nbytes`` shared memory each
    (``cudaOccupancyMaxActiveClusters`` through ``repro_<lib>_cluster_room``),
    asked once per device and size.  A CUDA error of the query raises
    :class:`~repro_torch.kernels._build.KernelLaunchError` (and is asked
    again next time); only the card's answer of no room means no.  For
    the CPU, the H100's answer: every size up to 16 at any share within a
    block's budget."""
    if device is None or torch.device(device).type != "cuda":
        return True
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _cluster_room(lib, index, c, nbytes) > 0


@functools.lru_cache(maxsize=None)
def _cluster_room(lib: str, index: int, c: int, nbytes: int) -> int:
    room = ctypes.c_int(0)
    _build.call(lib, f"repro_{lib}_cluster_room", (index, c, nbytes, ctypes.addressof(room)))
    return room.value


_card_admits = functools.partial(card_admits, "whole2d")


def pick_cluster(fits: Callable[[int], bool], b: int, share: Callable[[int], int],
                 sms: int) -> int:
    """Blocks per image or volume of ``b`` of them, 0 for none: the
    smallest c in ``CLUSTER_SIZES`` that ``fits``, then doubled while the
    doubled size fits, the ``b * 2c`` blocks stay within the card's
    ``sms`` and ``share(2c)`` keeps ``CLUSTER_MIN_SHARE`` samples a
    block."""
    sizes = [c for c in CLUSTER_SIZES if fits(c)]
    if not sizes:
        return 0
    c = sizes[0]
    while 2 * c in sizes and 2 * b * c <= sms and share(2 * c) >= CLUSTER_MIN_SHARE:
        c *= 2
    return c


def _pick_cluster(b: int, h: int, w: int, levels: int, device) -> int:
    """Blocks per image of a chain of ``levels`` levels (:func:`pick_cluster`
    over :func:`chain_fits`, a share being the block's first-level rows),
    each image counted twice in a chain of two or more: past the first
    level a wider cluster's barriers cost more than its blocks save.  The
    c sweeps of ``tools/whole2d_anatomy.py`` (1-16 images, chains of 1-3
    levels) read fastest, or within 1% of it, at the c this picks."""
    return pick_cluster(lambda c: chain_fits(h, w, levels, c, device), b * min(levels, 2),
                        lambda c: (_cdiv(chain_groups(h, levels), c) << levels) * w,
                        _backend.budgets(device)["sms"])


def chain_launches(
    b: int, h: int, w: int, levels: int, device: Optional[torch.device] = None
) -> Tuple[Tuple[int, int], ...]:
    """How a run of ``levels`` whole-image levels of a (b, h, w) batch
    launches, in forward order: ``(n, c)`` per launch — one cluster of c
    blocks per image running n levels, the longest chain from that level
    that some c holds (:func:`_pick_cluster`) — or ``(1, 0)``: one level
    that no cluster holds, the row and column passes."""
    dev = None if device is None else torch.device(device)
    return _chain_launches(b, h, w, levels, dev)


@functools.lru_cache(maxsize=256)
def _chain_launches(b, h, w, levels, device) -> Tuple[Tuple[int, int], ...]:
    out = []
    while levels:
        for n in range(min(levels, CHAIN_MAX), 0, -1):
            c = _pick_cluster(b, h, w, n, device)
            if c:
                break
        out.append((n, c))
        for _ in range(n):
            h, w = _cdiv(h, 2), _cdiv(w, 2)
        levels -= n
    return tuple(out)


def whole_geometry(
    b: int, h: int, w: int, device: Optional[torch.device] = None
) -> Dict[str, int]:
    """Launch geometry of the two-pass whole-image level for a (b, h, w)
    level (the level no cluster holds).

    ``rb`` rows per row-pass block; ``cw`` columns per column-pass strip,
    halved until the strip's full height fits one block's shared memory.
    A row (or a one-column strip) too long for shared memory is staged in
    a global scratch buffer instead (``row_global`` / ``col_global``) of
    ``scratch`` int32 entries, shared by both passes.
    """
    rows = _backend.row_geometry(b * h, w, device)
    cw = _backend.strip_width(h, device)
    scratch = max(rows["scratch"], _backend.col_scratch(b, h, (w - w // 2, w // 2), cw))
    return {"rb": rows["rb"], "row_global": rows["row_global"], "cw": cw or _backend.STRIP,
            "col_global": int(cw == 0), "scratch": scratch}


def _level_dims(h: int, w: int, levels: int) -> List[Tuple[int, int]]:
    """(h, w) of each level's image, finest first."""
    dims = []
    for _ in range(levels):
        dims.append((h, w))
        h, w = _cdiv(h, 2), _cdiv(w, 2)
    return dims


def _band_shapes(h: int, w: int) -> List[Tuple[int, int]]:
    """The (h, w) of a level's four bands in code order (bit 0: highpass
    along W, bit 1: along H): ll, hl, lh, hh."""
    he, ho, we, wo = h - h // 2, h // 2, w - w // 2, w // 2
    return [(he, we), (he, wo), (ho, we), (ho, wo)]


_View = Tuple[Tuple[int, int, int], Tuple[int, int, int], int]  # shape, strides, offset


class _Launch(NamedTuple):
    """One launch of a run: levels [k0, k0 + n) at c blocks an image (0:
    the row and column passes of one level, whose ``geometry`` it
    carries), and the launcher's integer arguments (ctypes objects) that
    follow its pointers."""

    k0: int
    n: int
    cluster: int
    geometry: Optional[Dict[str, int]]
    ints: Tuple[object, ...]


class _ChainPlan(NamedTuple):
    """What one whole-image call of a run of levels of a shape, scheme and
    direction needs besides its tensors, built once: the launches
    (:func:`chain_launches`, in forward order); each level's (h, w); the
    views of the call's one allocation of ``total`` int32 entries, each
    on a 16-byte boundary — forward: ``bands[k][code]`` (every level's
    hl, lh, hh, and the ll of each launch's last level), inverse:
    ``images[j]``, the image launch j writes (launch 0's is the output);
    per forward cluster launch, the byte offsets of its 4 * n band
    addresses in that allocation (``offsets``, None for the others); and
    the scheme table (``table`` keeps the array the ints point to
    alive)."""

    launches: Tuple[_Launch, ...]
    dims: Tuple[Tuple[int, int], ...]
    bands: Tuple[Tuple[Optional[_View], ...], ...]
    images: Tuple[_View, ...]
    total: int
    offsets: Tuple[Optional[np.ndarray], ...]
    table: np.ndarray


@functools.lru_cache(maxsize=256)
def _chain_plan(bsz, h, w, levels, sch, mode, inverse, device, cluster=None) -> _ChainPlan:
    """The plan of a run of ``levels`` whole-image levels of a (bsz, h, w)
    batch; ``cluster`` forces every level into one launch at that cluster
    size (0: the two passes, one level only), for the card tests and
    ``chip_smoke.py``'s sweep — a size the shape or the card cannot take
    raises at the launch."""
    if cluster is None:
        runs = _chain_launches(bsz, h, w, levels, device)
    elif cluster == 0 and levels != 1:
        raise ValueError("the two passes run one level")
    else:
        runs = ((levels, cluster),)
    dims = _level_dims(h, w, levels)
    table = _build.cascade_table(sch, mode, inverse)
    tail = (ctypes.c_void_p(table.ctypes.data), ctypes.c_int(len(table)))
    total = 0

    def view(hh: int, ww: int) -> _View:
        nonlocal total
        off = total
        total += _cdiv(bsz * hh * ww, 4) * 4
        return (bsz, hh, ww), (hh * ww, ww, 1), off

    launches, images = [], []
    bands: List[List[Optional[_View]]] = [[None] * 4 for _ in range(levels)]
    k0 = 0
    for n, c in runs:
        lh, lw = dims[k0]
        if c:
            g = None
            ints = tuple(ctypes.c_int(v) for v in (bsz, lh, lw, n, c)) + tail
        else:
            g = whole_geometry(bsz, lh, lw, device)
            ints = tuple(ctypes.c_int(v) for v in (bsz, lh, lw, g["rb"], g["row_global"],
                                                   g["cw"], g["col_global"])) + tail
        launches.append(_Launch(k0, n, c, g, ints))
        if inverse:
            images.append(view(lh, lw))
        else:
            for k in range(k0, k0 + n):
                shapes = _band_shapes(*dims[k])
                for code in (1, 2, 3) + ((0,) if k == k0 + n - 1 else ()):
                    bands[k][code] = view(*shapes[code])
        k0 += n
    offsets = []
    for ln in launches:
        if inverse or not ln.cluster:
            offsets.append(None)
            continue
        # the ll of a level inside a chain is never touched: any address does
        offs = [4 * (bands[k][code] or bands[k][1])[2]
                for k in range(ln.k0, ln.k0 + ln.n) for code in range(4)]
        offsets.append(np.asarray(offs, np.int64))
    return _ChainPlan(tuple(launches), tuple(dims), tuple(tuple(b) for b in bands),
                      tuple(images), total, tuple(offsets), table)


def _views(flat: Tensor, specs) -> List[Optional[Tensor]]:
    return [None if v is None else flat.as_strided(*v) for v in specs]


def _run_fwd(x: Tensor, plan: _ChainPlan):
    """The forward launches of ``plan`` on a (B, H, W) int32 CUDA batch:
    the last level's ll and each level's (lh, hl, hh), finest first, all
    views of one allocation."""
    dev = _build.check_tensors("fwd2d_whole", [x])
    flat = x.new_empty((plan.total,))
    bands = [_views(flat, lv) for lv in plan.bands]
    base, stream = flat.data_ptr(), _build.current_stream_handle(dev)
    src = x
    for ln, offs in zip(plan.launches, plan.offsets):
        if ln.cluster:
            ptrs = offs + base
            _build.call("whole2d", "repro_whole2d_cluster_fwd",
                        (dev, src.data_ptr(), ptrs.ctypes.data, *ln.ints, stream))
        else:
            ll, hl, lh, hh = bands[ln.k0]
            held = _pass_buffers(src, ln.geometry, plan.dims[ln.k0])
            _build.call("whole2d", "repro_whole_fwd", (
                dev, src.data_ptr(), *(_build._ptr(t) for t in held[:2]), ll.data_ptr(),
                lh.data_ptr(), hl.data_ptr(), hh.data_ptr(), _build._ptr(held[2]), *ln.ints,
                stream))
        _backend.launches.bump("whole2d_fwd")
        src = bands[ln.k0 + ln.n - 1][0]
    return src, [(lv[2], lv[1], lv[3]) for lv in bands]


def _run_inv(ll: Tensor, details: Sequence[Tuple[Tensor, Tensor, Tensor]],
             plan: _ChainPlan) -> Tensor:
    """The inverse launches of ``plan``: the coarsest ll and each level's
    (lh, hl, hh), coarsest first, to the (B, H, W) image."""
    levels = len(plan.dims)
    dev = _build.check_tensors("inv2d_whole", [ll, *(b for d in details for b in d)])
    flat = ll.new_empty((plan.total,))
    images = _views(flat, plan.images)
    stream = _build.current_stream_handle(dev)
    src = ll
    for j in range(len(plan.launches) - 1, -1, -1):
        ln, out = plan.launches[j], images[j]
        if ln.cluster:
            ptrs = np.zeros(4 * ln.n, np.int64)
            for i, k in enumerate(range(ln.k0, ln.k0 + ln.n)):
                lh, hl, hh = details[levels - 1 - k]
                ptrs[4 * i + 1:4 * i + 4] = (hl.data_ptr(), lh.data_ptr(), hh.data_ptr())
            ptrs[4 * ln.n - 4] = src.data_ptr()
            _build.call("whole2d", "repro_whole2d_cluster_inv",
                        (dev, ptrs.ctypes.data, out.data_ptr(), *ln.ints, stream))
        else:
            lh, hl, hh = details[levels - 1 - ln.k0]
            held = _pass_buffers(src, ln.geometry, plan.dims[ln.k0])
            _build.call("whole2d", "repro_whole_inv", (
                dev, src.data_ptr(), lh.data_ptr(), hl.data_ptr(), hh.data_ptr(),
                _build._ptr(held[0]), _build._ptr(held[1]), out.data_ptr(),
                _build._ptr(held[2]), *ln.ints, stream))
        _backend.launches.bump("whole2d_inv")
        src = out
    return src


def _pass_buffers(ref: Tensor, g: Dict[str, int], hw: Tuple[int, int]):
    """The row bands s_r, d_r and the scratch of one two-pass level."""
    bsz = ref.shape[0]
    h, w = hw
    scratch = ref.new_empty((g["scratch"],)) if g["scratch"] else None
    return ref.new_empty((bsz, h, w - w // 2)), ref.new_empty((bsz, h, w // 2)), scratch


def fwd2d_chain_plain(x: Tensor, levels: int, mode: str, scheme="cdf53"):
    """The plain version of a whole-image run: ``levels`` reference
    levels (``core.lifting``) of a (B, H, W) batch, as the last ll and
    each level's (lh, hl, hh), finest first."""
    details = []
    for _ in range(levels):
        x, lh, hl, hh = _fwd2d_math(x, mode, scheme)
        details.append((lh, hl, hh))
    return x, details


def inv2d_chain_plain(ll: Tensor, details, mode: str, scheme="cdf53") -> Tensor:
    """The plain version of an inverse run (details coarsest first)."""
    for lh, hl, hh in details:
        ll = _inv2d_math(ll, lh, hl, hh, mode, scheme)
    return ll


def fwd2d_chain_cuda(x: Tensor, levels: int, mode: str, scheme="cdf53"):
    """Launch ``csrc/whole2d.cu`` forward over a run of ``levels``
    whole-image levels of a (B, H, W) int32 CUDA batch: one cluster launch
    per chain of :func:`chain_launches` (the row and column passes for a
    level no cluster holds).  Returns the last ll and each level's (lh,
    hl, hh), finest first, all views of one allocation.  Replaces
    ``repro.kernels.fused2d._fwd2d_pallas`` (``_fwd2d_kernel``), one
    launch a level there."""
    sch = S.get_scheme(scheme)
    _tiled.check_level_input(x)
    bsz, h, w = x.shape
    check_levels_2d(h, w, levels)
    return _run_fwd(x, _chain_plan(bsz, h, w, levels, sch, mode, False, x.device))


def inv2d_chain_cuda(ll: Tensor, details, mode: str, scheme="cdf53") -> Tensor:
    """Launch ``csrc/whole2d.cu`` inverse over a run of whole-image levels
    (``details``: each level's (lh, hl, hh), coarsest first) to the
    (B, H, W) int32 image.  Replaces ``repro.kernels.fused2d._inv2d_pallas``
    (``_inv2d_kernel``)."""
    sch = S.get_scheme(scheme)
    bsz, h, w = _run_dims(ll, details)
    return _run_inv(ll, details, _chain_plan(bsz, h, w, len(details), sch, mode, True,
                                             ll.device))


def _run_dims(ll: Tensor, details) -> Tuple[int, int, int]:
    """(B, H, W) of the image a run's bands rebuild; raises unless every
    level's bands are the shapes a forward level produces."""
    if not details:
        raise ValueError("need at least one level of bands")
    shape = tuple(ll.shape)
    for lh, hl, hh in details:
        if len(shape) != 3:
            raise ValueError(f"need (B, h, w) bands, got ll {shape}")
        bsz, he, we = shape
        ho, wo = lh.shape[-2], hl.shape[-1]
        got = [tuple(a.shape) for a in (lh, hl, hh)]
        if (got != [(bsz, ho, we), (bsz, he, wo), (bsz, ho, wo)] or he - ho not in (0, 1)
                or we - wo not in (0, 1) or not ho or not wo):
            raise ValueError(f"band shape mismatch: ll/lh/hl/hh = {[shape] + got}")
        shape = (bsz, he + ho, we + wo)
    return shape


def fwd2d_whole_cuda(x: Tensor, mode: str, scheme="cdf53"):
    """One whole-image forward level on a CUDA batch (a run of one):
    (ll, lh, hl, hh)."""
    ll, ((lh, hl, hh),) = fwd2d_chain_cuda(x, 1, mode, scheme)
    return ll, lh, hl, hh


def inv2d_whole_cuda(ll: Tensor, lh: Tensor, hl: Tensor, hh: Tensor, mode: str,
                     scheme="cdf53") -> Tensor:
    """One whole-image inverse level on CUDA bands (a run of one)."""
    return inv2d_chain_cuda(ll, [(lh, hl, hh)], mode, scheme)


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


def fwd2d_chain(x: Tensor, levels: int, mode: str, scheme="cdf53"):
    """A run of ``levels`` whole-image forward levels over a (B, H, W)
    int32 batch: the kernels for a CUDA tensor (:func:`fwd2d_chain_cuda`),
    :func:`fwd2d_chain_plain` for a CPU tensor."""
    if _backend.on_cuda(x):
        return fwd2d_chain_cuda(x, levels, mode, scheme)
    return fwd2d_chain_plain(x, levels, mode, scheme)


def inv2d_chain(ll: Tensor, details, mode: str, scheme="cdf53") -> Tensor:
    """The inverse of a run (``details`` coarsest first): the kernels for
    CUDA tensors, :func:`inv2d_chain_plain` for CPU tensors."""
    if _backend.on_cuda(ll):
        return inv2d_chain_cuda(ll, details, mode, scheme)
    return inv2d_chain_plain(ll, details, mode, scheme)


# ---------------------------------------------------------------------------
# Level dispatch: tiled past the whole-image budget (or when forced),
# whole-image otherwise — a kernel either way on a CUDA tensor.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
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


def plan_2d(h: int, w: int, device="cuda", scheme="cdf53") -> str:
    """Name the path a (h, w) level takes on ``device``: ``whole-cuda``,
    ``tiled-cuda``, ``whole-torch`` or ``tiled-torch`` (the ``-torch``
    names are the plain versions a CPU tensor runs).  The default is the
    card; without one it raises."""
    dev = _backend.resolve_device(device)
    kind = "tiled" if _use_tiled(h, w, S.get_scheme(scheme), dev) else "whole"
    return f"{kind}-{'cuda' if dev.type == 'cuda' else 'torch'}"


def level_runs(dims: Sequence[Tuple[int, int]], sch: S.LiftingScheme,
               device=None) -> List[Tuple[bool, int]]:
    """The levels of a pyramid (each level's (h, w), in the order they
    run) grouped as they launch: ``(True, 1)`` for a tiled level, ``(False,
    n)`` for each maximal run of n consecutive whole-image levels, which
    run as one call (:func:`fwd2d_chain` / :func:`inv2d_chain`)."""
    runs: List[Tuple[bool, int]] = []
    for h, w in dims:
        tiled = _use_tiled(h, w, sch, device)
        if runs and not tiled and not runs[-1][0]:
            runs[-1] = (False, runs[-1][1] + 1)
        else:
            runs.append((tiled, 1))
    return runs


def _level_span(level: int, tiled: bool, direction: str):
    """The ``kernels.level`` span of one tiled level or of one whole-image
    chain run, named by its finest level (1 is the finest)."""
    return tracer.record("kernels.level", "kernels", level=level,
                         engine="tiled2d" if tiled else "whole2d", direction=direction)


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


def _flat(a: Tensor, lead: Tuple[int, ...]) -> Tensor:
    """(*lead, h, w) -> contiguous (B, h, w) in the compute dtype; a
    contiguous int32 (B, h, w) band as it is."""
    if a.ndim == 3 and a.dtype == torch.int32 and a.is_contiguous():
        return a
    return a.reshape((-1,) + tuple(a.shape[len(lead):])).to(_compute_dtype(a.dtype)).contiguous()


def dwt_fwd_2d(x: Tensor, mode: str = "paper", scheme="cdf53", checked=None) -> Bands2D:
    """One 2-D level over the last two axes (rows then columns), on the
    device ``x`` lives on.  ``checked=True`` (or ``REPRO_DWT_CHECKED=1``)
    certifies the data against the derived range bounds and raises
    ``IntegerOverflowError`` instead of ever returning wrapped bands
    (``core/ranges.py``)."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if x.ndim < 2 or x.shape[-1] < 2 or x.shape[-2] < 2:
        raise ValueError(f"need a (..., H>=2, W>=2) input, got {tuple(x.shape)}")
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked(
            lambda a: dwt_fwd_2d(a, mode=mode, scheme=sch, checked=False),
            x, scheme=sch, levels=1, mode=mode, ndim=2, label="kernels.dwt_fwd_2d",
        )
    lead = tuple(x.shape[:-2])
    bands = _fwd2d_level(_flat(x, lead), sch, mode)
    return Bands2D(*(b.reshape(lead + tuple(b.shape[1:])) for b in bands))


def dwt_inv_2d(bands: Bands2D, mode: str = "paper", scheme="cdf53", checked=None) -> Tensor:
    """Inverse of :func:`dwt_fwd_2d` (columns then rows)."""
    S.check_mode(mode)
    sch = S.get_scheme(scheme)
    if _ranges.checked_enabled(checked):
        return _ranges.run_checked_inv(
            lambda b: dwt_inv_2d(b, mode=mode, scheme=sch, checked=False),
            bands, scheme=sch, levels=1, mode=mode, ndim=2, label="kernels.dwt_inv_2d",
        )
    lead = tuple(bands.ll.shape[:-2])
    x = _inv2d_level(*(_flat(b, lead) for b in bands), sch, mode)
    return x.reshape(lead + tuple(x.shape[1:]))


def dwt_fwd_2d_multi(
    x: Tensor, levels: int = 1, mode: str = "paper", scheme="cdf53", checked=None
) -> Pyramid2D:
    """Multi-level 2-D forward transform (Mallat pyramid), fine levels
    tiled and coarse levels whole-image, on the device ``x`` lives on."""
    with _backend.call_span("fwd", 2, levels, x.shape[:-2]) if _obs.kernels else NULL:
        S.check_mode(mode)
        sch = S.get_scheme(scheme)
        if x.ndim < 2:
            raise ValueError(f"need a (..., H, W) input, got {tuple(x.shape)}")
        check_levels_2d(x.shape[-2], x.shape[-1], levels)
        if _ranges.checked_enabled(checked):
            return _ranges.run_checked(
                lambda a: dwt_fwd_2d_multi(a, levels=levels, mode=mode, scheme=sch, checked=False),
                x, scheme=sch, levels=levels, mode=mode, ndim=2, label="kernels.dwt_fwd_2d_multi",
            )
        lead = tuple(x.shape[:-2])
        ll = _flat(x, lead)
        details: List[Tuple[Tensor, Tensor, Tensor]] = []
        dims = _level_dims(ll.shape[-2], ll.shape[-1], levels)
        for tiled, n in level_runs(dims, sch, ll.device):
            with _level_span(len(details) + 1, tiled, "fwd") if _obs.kernels else NULL:
                if tiled:
                    ll, lh, hl, hh = _fwd2d_level(ll, sch, mode)
                    details.append((lh, hl, hh))
                else:
                    ll, run = fwd2d_chain(ll, n, mode, sch)
                    details.extend(run)

        def unlead(a: Tensor) -> Tensor:
            return a if len(lead) == 1 else a.reshape(lead + tuple(a.shape[1:]))

        return Pyramid2D(
            ll=unlead(ll),
            details=tuple(tuple(unlead(b) for b in lvl) for lvl in reversed(details)),
        )


def dwt_inv_2d_multi(
    pyr: Pyramid2D, mode: str = "paper", scheme="cdf53", checked=None
) -> Tensor:
    """Inverse of :func:`dwt_fwd_2d_multi`."""
    with (_backend.call_span("inv", 2, len(pyr.details), pyr.ll.shape[:-2])
          if _obs.kernels else NULL):
        S.check_mode(mode)
        sch = S.get_scheme(scheme)
        if _ranges.checked_enabled(checked):
            return _ranges.run_checked_inv(
                lambda p: dwt_inv_2d_multi(p, mode=mode, scheme=sch, checked=False),
                pyr, scheme=sch, levels=len(pyr.details), mode=mode, ndim=2,
                label="kernels.dwt_inv_2d_multi",
            )
        ll = pyr.ll
        h, w = ll.shape[-2], ll.shape[-1]
        dims = []
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
            dims.append((h, w))
        lead = tuple(ll.shape[:-2])
        x = _flat(ll, lead)
        k = 0
        for tiled, n in level_runs(dims, sch, x.device):  # coarsest first
            # a chain run's span is named by its finest level
            with _level_span(len(dims) - k - n + 1, tiled, "inv") if _obs.kernels else NULL:
                run = [tuple(_flat(b, lead) for b in lvl) for lvl in pyr.details[k:k + n]]
                x = _inv2d_level(x, *run[0], sch, mode) if tiled else inv2d_chain(x, run, mode, sch)
            k += n
        return x if len(lead) == 1 else x.reshape(lead + tuple(x.shape[1:]))


# ---------------------------------------------------------------------------
# (5,3) aliases, as in the reference; ``checked=`` passes through.
# ---------------------------------------------------------------------------


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
